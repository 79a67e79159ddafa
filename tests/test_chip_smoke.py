"""chip_smoke.py without a GPU: it must refuse, never report success, and
select its phases as documented. Its phases themselves run on the card."""

import json
import os
import shutil
import subprocess
import sys

from tests.conftest import REPO

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (importing starts no JAX work)


def _run(args, cwd=REPO, script=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script or os.path.join(REPO, "chip_smoke.py")]
        + args, capture_output=True, text=True, env=env, cwd=cwd,
        timeout=300)


def _last_line_not_ok(stdout):
    lines = [l for l in stdout.splitlines() if l.strip()]
    if not lines:
        return True
    try:
        return json.loads(lines[-1]).get("ok") is not True
    except (json.JSONDecodeError, AttributeError):
        return True


def test_exits_nonzero_on_cpu():
    r = _run([])
    assert r.returncode != 0
    assert _last_line_not_ok(r.stdout)
    assert "no GPU found" in r.stderr


def test_four_cards_exits_nonzero_on_cpu():
    r = _run(["--four-cards"])
    assert r.returncode != 0
    assert _last_line_not_ok(r.stdout)


def test_alone_in_a_directory_exits_nonzero(tmp_path):
    script = str(tmp_path / "chip_smoke.py")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    r = _run([], cwd=str(tmp_path), script=script)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "not beside this file" in r.stderr


def test_four_cards_selects_only_that_phase():
    assert chip_smoke.phases(True) == ("four_cards",)
    one = chip_smoke.phases(False)
    assert "four_cards" not in one
    assert one == ("device", "parity", "main_path", "samplers", "gpu_vs_cpu")


def test_result_parsers():
    out = "\n".join([
        "RESULT : it    0, rank    0: proc =     9.000 s, sync = 0",
        "RESULT : it   10, rank    0: proc =     0.120 s, sync = 0",
        "RESULT : it   20, rank    0: proc =     0.100 s, sync = 0",
        "RESULT : it   30, rank    0: proc =     0.140 s, sync = 0"])
    assert abs(chip_smoke.result_ms_per_sweep(out) - 120.0) < 1e-9
    rows = [[0, 1, 0.2, 0.8, 0.2], [150, 1, 0.5, 0.5, 0.5],
            [155, 1, 0.3, 0.7, 0.3]]
    assert abs(chip_smoke.h2_posterior(rows, 150) - 0.4) < 1e-12
