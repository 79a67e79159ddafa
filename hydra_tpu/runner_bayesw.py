"""BayesW chain runner with hydra-format outputs (BayesW.cpp:1935-2090)."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from hydra_tpu.data.genotypes import Dataset
from hydra_tpu.options import Options
from hydra_tpu.outputs.restart import read_restart
from hydra_tpu.outputs.writers import McmcWriter
from hydra_tpu.runner import _fetch_host, _iter_blocks, _last_stats
from hydra_tpu.samplers.bayesw import BayesW


def run_bayesw(opt: Options, dataset: Optional[Dataset] = None,
               verbose: bool = True) -> dict:
    from hydra_tpu.runner import dataset_from_options

    ds = dataset if dataset is not None else dataset_from_options(opt)

    mcmc_out = opt.mcmc_out
    rd = None
    if opt.restart:
        from hydra_tpu.runner import apply_restart_rng
        rd = read_restart(mcmc_out, ds.m, ds.n, opt.save,
                          use_xfiles=opt.use_xfiles_in_restart,
                          covariates=opt.covariates, survival=True)
        apply_restart_rng(opt, rd)
        opt.mcmc_out_name += "_rs"
        mcmc_out = opt.mcmc_out

    sampler = BayesW(ds, window=opt.window, shuffle=bool(opt.shuffle_markers),
                     seed=opt.seed, quad_points=int(opt.quad_points),
                     n_devices=opt.n_devices, n_ind=opt.ind_shards,
                     n_dcn=opt.dcn_slices,
                     schedule=opt.schedule, det_sync=bool(opt.det_sync))

    if rd is not None:
        state = sampler.init_state_from_restart(rd)
        start_it = rd.start_iteration
    else:
        state = sampler.init_state()
        start_it = 0

    from hydra_tpu.outputs.writers import NullWriter
    from hydra_tpu.parallel.distributed import is_primary
    primary = is_primary()
    writer = McmcWriter(mcmc_out, ds.m, ds.n, ds.num_groups, ds.mS.shape[1],
                        opt.thin, opt.save, opt.seed,
                        covariates=opt.covariates, survival=True,
                        # window=1 IS exact sequential BayesW (level sums +
                        # draw + vi refresh per marker) — record it as such
                        window=opt.window, exact=(opt.window == 1),
                        schedule=sampler.cfg.schedule) if primary else NullWriter()
    marker_order = sampler.slot_to_marker[sampler.slot_to_marker >= 0].astype(np.int32)

    stats = None
    for it, k in _iter_blocks(start_it, opt.chain_length, opt.thin,
                              opt.save, verbose):
        t0 = time.time()
        if k == 1:
            state, stats = sampler.step(state, it)
        else:
            # fused dispatch between writer/telemetry events (see runner.py)
            state, stats = sampler.run_steps(state, it - k + 1, k)
            stats = _last_stats(stats)
        on_thin = it % opt.thin == 0
        on_save = it > 0 and it % opt.save == 0
        on_log = verbose and it % 10 == 0
        if on_thin or on_save or on_log:
            pulls = dict(sigma_g=state.sigma_g, mu=state.mu,
                         alpha=state.alpha, m0=stats.m0)
            if on_thin or on_save:
                pulls.update(beta=state.beta, components=state.components)
            if on_thin:
                pulls.update(pi_l=state.pi_l)
                if opt.covariates:
                    pulls.update(gamma=state.gamma)
            if on_save:
                pulls.update(eps=state.eps)
            h = _fetch_host(pulls)  # one batched device->host pull
        if on_thin or on_save:
            sel = sampler.slot_to_marker >= 0
            beta_g = np.zeros(ds.m)
            beta_g[sampler.slot_to_marker[sel]] = \
                h["beta"].astype(np.float64)[sel]
            comp_g = np.zeros(ds.m, dtype=np.int32)
            comp_g[sampler.slot_to_marker[sel]] = h["components"][sel]
        if on_thin:
            sg = h["sigma_g"].astype(np.float64)
            row = writer.csv_row_bw(it, float(h["mu"]), sg, float(h["alpha"]),
                                    int(h["m0"].sum()),
                                    h["pi_l"].astype(np.float64))
            gamma_text = None
            if opt.covariates:
                g = h["gamma"].astype(np.float64)
                gamma_text = (f"{it:5d}, "
                              + ", ".join(f"{v:20.17f}" for v in g) + "\n")
            writer.on_thin(it, beta_g, comp_g, row,
                           float(h["mu"]), gamma_text=gamma_text)
        if on_save:
            eps = h["eps"].astype(np.float64)[: ds.n]
            writer.on_save(it, eps, marker_order, beta_g, comp_g,
                           x_order=(sampler.cov_order(it)
                                    if opt.covariates else None))
        if on_log and primary:
            print(f"{it}. m0={int(h['m0'].sum())}; "
                  f"mu={float(h['mu']):.5f}; alpha={float(h['alpha']):.5f}; "
                  f"sigmaG={float(h['sigma_g'].sum()):.5f} "
                  f"({time.time() - t0:.3f}s)", flush=True)

    return dict(state=state, stats=stats, sampler=sampler, mcmc_out=mcmc_out)
