"""Device selection and the persistent compile cache, set once per process.

The samplers run on an NVIDIA GPU. The CPU is used only when asked for:
`--device cpu`, or `JAX_PLATFORMS=cpu` in the environment (the tests run
that way, on a virtual multi-device CPU mesh). Anything else that finds no
GPU stops with an error instead of falling back to the CPU.

GPU executables are cached on disk: in `JAX_COMPILATION_CACHE_DIR` when that
is set, otherwise in `.jax_cache/` at the root of the checkout. The path is
fixed, because it is part of the cache key. CPU runs (tests) compile small
programs and keep no cache unless the environment variable asks for one.
"""

from __future__ import annotations

import os

DEVICES = ("cpu", "gpu")
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


class NoDeviceError(RuntimeError):
    """The requested platform has no device in this process."""


def requested_device(device: str = "") -> str:
    """The platform to run on: the explicit choice, else the CPU when
    JAX_PLATFORMS names only the CPU, else the GPU."""
    if device:
        if device not in DEVICES:
            raise ValueError(f"--device must be one of {DEVICES}, "
                             f"got {device!r}")
        return device
    env = os.environ.get("JAX_PLATFORMS", "").strip().lower()
    return "cpu" if env == "cpu" else "gpu"


def select_platform(device: str = "") -> str:
    """Point JAX at the requested platform and switch on the compile cache.
    Must run before any backend starts (and before jax.distributed is
    initialised). Returns "cpu" or "gpu"."""
    import jax

    want = requested_device(device)
    jax.config.update("jax_platforms", "cpu" if want == "cpu" else "cuda")
    if want == "gpu" and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return want


def require_device(want: str) -> str:
    """Start the backend and check that it runs on `want`."""
    import jax

    try:
        platform = jax.devices()[0].platform
    # RuntimeError: the backend failed to start; AssertionError: JAX has no
    # backend at all for the requested platform (no GPU plugin installed)
    except (RuntimeError, AssertionError) as e:
        detail = f" ({e})" if str(e) else ""
        raise NoDeviceError(
            f"no {want.upper()} found{detail}; pass --device cpu or set "
            "JAX_PLATFORMS=cpu to run on the CPU") from None
    if platform != want:
        raise NoDeviceError(f"asked for {want}, JAX runs on {platform}")
    return platform


def configure(device: str = "") -> str:
    """select_platform + require_device, for single-process entry points."""
    return require_device(select_platform(device))
