"""Chain runner: wires Options -> Dataset -> sampler -> writers/restart.

Equivalent of the orchestration in main.cpp:47-177 plus the in-sampler output
blocks (BayesRRm.cpp:2736-2877). The Gibbs sweep runs on device; thin/save
boundaries pull state to host and append to the hydra-format files.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from hydra_tpu.data.genotypes import Dataset, load_dataset
from hydra_tpu.io import groups as groups_io
from hydra_tpu.io import pheno as pheno_io
from hydra_tpu.options import Options
from hydra_tpu.outputs.restart import read_restart
from hydra_tpu.outputs.writers import McmcWriter
from hydra_tpu.samplers.bayesrrm import BayesRRm
from hydra_tpu.utils import telemetry


def _iter_blocks(start_it: int, chain_length: int, thin: int, save: int,
                 verbose: bool):
    """Yield (it, k): run k fused sweeps landing exactly ON iteration it.

    Host access is only needed at thin/save boundaries and the RESULT
    telemetry line (every 10th iteration when verbose); everything between
    is fused into ONE lax.scan dispatch (sampler.run_steps — identical
    chain, tests pin it), so the host leaves the loop between boundaries.
    """
    def is_event(i):
        return (i % thin == 0 or (i > 0 and i % save == 0)
                or (verbose and i % 10 == 0) or i == chain_length - 1)

    it = start_it
    while it < chain_length:
        e = it
        while not is_event(e):
            e += 1
        yield e, e - it + 1
        it = e + 1


def _last_stats(stats):
    """Last step's IterStats from a run_steps stacked result."""
    import jax
    return jax.tree.map(lambda x: x[-1], stats)


def _fetch_host(tree: dict) -> dict:
    """Pull a dict of device arrays to host in ONE batched transfer.

    jax.device_get issues copy_to_host_async on every leaf before any
    blocking conversion, so the boundary pays one transfer latency instead
    of one per array.

    Multi-process: marker-sharded leaves all-gather collectively (every
    process calls this at the same boundary — parallel/distributed.py)."""
    from hydra_tpu.parallel.distributed import fetch_global
    return fetch_global(tree)


def _mp_marker_slice(opt: Options, m: int, blocks=None):
    """Per-host read range: each process loads only the .bed rows of its own
    marker shards (the MPI-IO collective-read analogue, data.cpp:671-739).
    Shard starts depend only on (m, n_dev, blocks), so this pre-computes the
    same layout the sampler will build. (0, None) single-process."""
    import jax
    if jax.process_count() <= 1 or not opt.read_from_bed_file:
        return 0, None
    from hydra_tpu.data.genotypes import shard_layout
    n_dev = opt.n_devices or len(jax.devices())
    starts, lens, _ = shard_layout(m, n_dev, max(opt.window, 1), blocks)
    me = jax.process_index()
    devs = jax.devices()[:n_dev]
    ids = [i for i, dv in enumerate(devs) if dv.process_index == me]
    lo = int(starts[min(ids)])
    hi = int(starts[max(ids)] + lens[max(ids)])
    return lo, hi - lo


def dataset_from_options(opt: Options) -> Dataset:
    """Input dispatch mirroring main.cpp:60-157."""
    n, m = opt.number_individuals, opt.number_markers
    if opt.read_from_bed_file and (n == 0 or m == 0):
        from hydra_tpu.io import plink
        n = plink.read_fam(opt.bed_file + ".fam").n
        m = plink.read_bim(opt.bed_file + ".bim").m

    is_bw = opt.bayes_type == "bayesWMPI"
    phen = opt.phenotype_files[0]
    if opt.covariates and is_bw:
        ph = pheno_io.read_phen_fail_cov_files(
            phen, opt.covariates_file, opt.failure_file, n)
    elif opt.covariates:
        ph = pheno_io.read_phen_cov_files(phen, opt.covariates_file, n)
    elif is_bw:
        ph = pheno_io.read_phen_fail_files(phen, opt.failure_file, n)
    else:
        ph = pheno_io.read_phenotype_file(phen, expected_n=n if n else None)

    grp = mS = None
    if opt.group_index_file:
        grp = groups_io.read_group_file(opt.group_index_file)
        mS = groups_io.read_ms_file(opt.group_mixture_file)
    priors = groups_io.read_group_priors(opt.priors_file) if opt.priors_file else None
    d_priors = (groups_io.read_dirichlet_priors(opt.d_priors_file)
                if opt.d_priors_file else None)
    blocks = (groups_io.read_marker_blocks_file(opt.marker_blocks_file)
              if opt.marker_blocks_file else None)

    marker_offset, marker_count = _mp_marker_slice(opt, m, blocks)

    return load_dataset(
        bed_basename=opt.bed_file if opt.read_from_bed_file else "",
        sparse_basename=(opt.sparse_dir + "/" + opt.sparse_basename
                         if opt.read_from_sparse_files else ""),
        pheno=ph, n=n, m=m, groups=grp, mS=mS, S=opt.S,
        priors=priors, d_priors=d_priors, blocks=blocks,
        marker_offset=marker_offset, marker_count=marker_count,
    )


def read_multi_phenos(opt: Options, n: int) -> np.ndarray:
    """Read T phenotype files into (T, N) with NaN for missing individuals
    (readPhenotypeFileAndSetNanMask semantics, data.cpp:1578-1609)."""
    rows = []
    for path in opt.phenotype_files:
        vals = []
        with open(path) as fh:
            for raw in fh:
                parts = raw.split()
                if not parts:
                    continue
                vals.append(np.nan if parts[2] == "NA" else float(parts[2]))
        if n and len(vals) != n:
            raise ValueError(f"{path}: expected {n} individuals, found {len(vals)}")
        rows.append(vals)
    return np.asarray(rows, dtype=np.float64)


def run_bayesrrm_mt(opt: Options, verbose: bool = True) -> dict:
    """Multi-trait chain (the reference declares but disables this path,
    main.cpp:73-75; enabled here). Writes per-trait csv/bet files suffixed
    .t<k>."""
    from hydra_tpu.data.genotypes import load_dataset
    from hydra_tpu.io import plink
    from hydra_tpu.io.pheno import PhenoData
    from hydra_tpu.samplers.bayesrrm_mt import BayesRRmMT

    n = opt.number_individuals or plink.read_fam(opt.bed_file + ".fam").n
    m = opt.number_markers or plink.read_bim(opt.bed_file + ".bim").m
    phenos = read_multi_phenos(opt, n)
    # genotypes keep all individuals; NaNs are masked, not removed
    ph = PhenoData(y=np.nan_to_num(phenos[0]),
                   na_indices=np.array([], dtype=np.int64))
    grp = mS = None
    if opt.group_index_file:
        from hydra_tpu.io import groups as groups_io
        grp = groups_io.read_group_file(opt.group_index_file)
        mS = groups_io.read_ms_file(opt.group_mixture_file)
    mo, mc = _mp_marker_slice(opt, m, None)
    ds = load_dataset(bed_basename=opt.bed_file, pheno=ph, n=n, m=m,
                      groups=grp, mS=mS, S=opt.S,
                      marker_offset=mo, marker_count=mc)
    if opt.covariates:
        # mt keeps all individuals (NaN masks, not removal) — covariates
        # are read full-N; per-trait masking happens inside the sampler
        import dataclasses as _dc
        X = pheno_io.read_csv_covariates(opt.covariates_file, n)
        ds = _dc.replace(ds, X=X)
    T = phenos.shape[0]
    _autosize_exact_window(opt, ds.n)
    mcmc_out = opt.mcmc_out
    rds = None
    if opt.restart:
        # per-trait restart files; state is rebuilt trait by trait
        rds = [read_restart(mcmc_out + f".t{t}", ds.m, ds.n, opt.save,
                            use_xfiles=opt.use_xfiles_in_restart)
               for t in range(T)]
        apply_restart_rng(opt, rds[0])
    sampler = BayesRRmMT(ds, phenos, window=opt.window, exact=opt.exact,
                         shuffle=bool(opt.shuffle_markers), seed=opt.seed,
                         n_devices=opt.n_devices, n_ind=opt.ind_shards,
                         n_dcn=opt.dcn_slices,
                         schedule=opt.schedule, det_sync=bool(opt.det_sync))
    start_it = 0
    if rds is not None:
        import jax.numpy as jnp
        import jax as _jax
        state = sampler.init_state()
        eps = np.asarray(state.eps).copy()
        beta = np.asarray(state.beta).copy()
        comps = np.asarray(state.components).copy()
        sel = sampler.slot_to_marker >= 0
        for t, rd in enumerate(rds):
            eps[: ds.n, t] = rd.eps
            beta[sel, t] = rd.beta[sampler.slot_to_marker[sel]]
            comps[sel, t] = rd.components[sampler.slot_to_marker[sel]]
        _mput = sampler._put
        state = state._replace(
            eps=_mput(jnp.asarray(eps, jnp.float32), sampler._shard_i2),
            beta=_mput(jnp.asarray(beta, jnp.float32), sampler._shard_m2),
            components=_mput(jnp.asarray(comps, jnp.int32),
                             sampler._shard_m2),
            mu=_mput(jnp.asarray([rd.mu for rd in rds], jnp.float32),
                     sampler._rep),
            sigma_e=_mput(
                jnp.asarray([rd.sigma_e for rd in rds], jnp.float32),
                sampler._rep),
            sigma_g=_mput(
                jnp.asarray(np.stack([rd.sigma_g for rd in rds]), jnp.float32),
                sampler._rep),
            est_pi=_mput(
                jnp.asarray(np.stack([rd.est_pi for rd in rds]), jnp.float32),
                sampler._rep),
        )
        if opt.covariates and all(rd.gamma is not None for rd in rds):
            state = state._replace(gamma=_mput(
                jnp.asarray(np.stack([rd.gamma for rd in rds], axis=1),
                            jnp.float32), sampler._rep))
        start_it = rds[0].start_iteration
        opt.mcmc_out_name += "_rs"
        mcmc_out = opt.mcmc_out
    else:
        state = sampler.init_state()
    from hydra_tpu.outputs.writers import NullWriter
    from hydra_tpu.parallel.distributed import is_primary
    primary = is_primary()
    writers = [
        McmcWriter(mcmc_out + f".t{t}", ds.m, ds.n, ds.num_groups,
                   ds.mS.shape[1], opt.thin, opt.save, opt.seed,
                   covariates=opt.covariates, window=opt.window,
                   exact=opt.exact, schedule=sampler.cfg.schedule)
        if primary else NullWriter()
        for t in range(T)
    ]
    marker_order = sampler.slot_to_marker[sampler.slot_to_marker >= 0].astype(np.int32)
    stats = None
    for it, k in _iter_blocks(start_it, opt.chain_length, opt.thin,
                              opt.save, verbose):
        if k == 1:
            state, stats = sampler.step(state, it)
        else:
            state, stats = sampler.run_steps(state, it - k + 1, k)
            stats = _last_stats(stats)
        on_thin = it % opt.thin == 0
        on_save = it > 0 and it % opt.save == 0
        on_log = verbose and it % 10 == 0
        if on_thin or on_save or on_log:
            pulls = dict(sigma_g=state.sigma_g, sigma_e=state.sigma_e)
            if on_thin or on_save:
                pulls.update(beta=state.beta, components=state.components,
                             mu=state.mu)
            if on_thin:
                pulls.update(m0=stats.m0, est_pi=state.est_pi,
                             acum=state.acum)
            if on_save:
                pulls.update(eps=state.eps, gamma=state.gamma)
            h = _fetch_host(pulls)  # one batched device->host pull
        if on_thin or on_save:
            sel = sampler.slot_to_marker >= 0
            beta_g = np.zeros((ds.m, T))
            beta_g[sampler.slot_to_marker[sel]] = \
                h["beta"].astype(np.float64)[sel]
        if on_thin:
            # padded markers report P(zero)=1 (sampler.acum_global semantics)
            acum_g = np.ones((ds.m, T))
            acum_g[sampler.slot_to_marker[sel]] = \
                h["acum"].astype(np.float64)[sel]
            for t, w in enumerate(writers):
                sg = h["sigma_g"].astype(np.float64)[t]
                se = float(h["sigma_e"][t])
                m0 = int(h["m0"][t].sum())
                row = w.csv_row_brr(it, sg, se, m0,
                                    h["est_pi"][t].astype(np.float64))
                comp_t = np.zeros(ds.m, dtype=np.int32)
                comp_t[sampler.slot_to_marker[sel]] = h["components"][sel, t]
                w.on_thin(it, beta_g[:, t], comp_t, row,
                          float(h["mu"][t]),
                          acum=acum_g[:, t])
        if on_save:
            eps_all = h["eps"].astype(np.float64)
            gamma_all = h["gamma"].astype(np.float64)
            for t, w in enumerate(writers):
                comp_t = np.zeros(ds.m, dtype=np.int32)
                comp_t[sampler.slot_to_marker[sel]] = h["components"][sel, t]
                w.on_save(it, eps_all[: ds.n, t], marker_order,
                          beta_g[:, t], comp_t,
                          gamma=(gamma_all[:, t] if opt.covariates else None))
        if on_log and primary:
            sg = h["sigma_g"].sum(axis=1)
            se = h["sigma_e"]
            print(f"RESULT : it {it:4d}: h2 per trait = "
                  f"{np.array2string(sg / (sg + se), precision=4)}", flush=True)
    return dict(state=state, stats=stats, sampler=sampler)


def _autosize_exact_window(opt: Options, n: int) -> None:
    """Size the exact-mode window once N is known: 128 for N > 16384, else
    the default 64. Exact mode is window-invariant (the Gram correction
    reproduces sequential Gibbs for any W), so this only changes speed: wide
    N amortizes per-window fixed costs until the O(W^2) in-window
    recurrence bites. Fires only for the auto default (options.py), never
    for a user-passed --window."""
    if opt.window_auto and opt.exact and n > 16384 and opt.window == 64:
        opt.window = 128
        print("INFO   : exact mode: window auto-sized to 128 for N > 16384 "
              "(window-invariant semantics)", flush=True)


def apply_restart_rng(opt: Options, rd) -> None:
    """Continue the saved chain's RNG stream (the reference restores the full
    boost state from .rng.<rank>, BayesRRm.cpp:1204,
    distributions_boost.cpp:38-55). The counter-based equivalent: adopt the
    saved seed — never the fresh time(0) default — and keep the saved chain
    schedule (window/exact) so the restarted chain is bitwise identical to
    the uninterrupted one."""
    if opt.seed_given and opt.seed != rd.seed:
        print(f"WARNING: --seed {opt.seed} differs from the saved RNG state "
              f"(seed {rd.seed}); using the saved seed to continue the chain",
              flush=True)
    opt.seed = rd.seed
    if rd.rng_window is not None and rd.rng_window != opt.window:
        if opt.window_auto:
            # the window was hardware-sized, not user-chosen: adopt the saved
            # chain's schedule so the restart stays bitwise-faithful
            print(f"INFO   : restart: adopting the saved chain's window "
                  f"{rd.rng_window} (auto default was {opt.window})",
                  flush=True)
            opt.window = rd.rng_window
        else:
            print(f"WARNING: restart with --window {opt.window} but the chain "
                  f"was saved with window {rd.rng_window}; the restarted chain "
                  f"will not reproduce the uninterrupted one", flush=True)
    saved_schedule = getattr(rd, "rng_schedule", None)
    if saved_schedule is not None and opt.schedule != saved_schedule:
        if opt.schedule == "auto":
            # the schedule was auto-resolved, not user-chosen: adopt the
            # saved chain's (same rule as the auto-sized window above) so
            # the restart continues the identical scan-order stream
            print(f"INFO   : restart: adopting the saved chain's "
                  f"'{saved_schedule}' schedule", flush=True)
            opt.schedule = saved_schedule
        else:
            print(f"WARNING: restart with --schedule {opt.schedule} but the "
                  f"chain was saved with '{saved_schedule}'; the restarted "
                  f"chain will not reproduce the uninterrupted one",
                  flush=True)
    # BayesW has no --exact switch: exactness there IS window == 1, which
    # is what its writer records
    eff_exact = (opt.window == 1 if opt.bayes_type == "bayesWMPI"
                 else opt.exact)
    if rd.rng_exact is not None and rd.rng_exact != eff_exact:
        print(f"WARNING: restart with exact={eff_exact} but the chain was "
              f"saved with exact={rd.rng_exact}; the restarted chain will "
              f"not reproduce the uninterrupted one", flush=True)


def run_bayesrrm(opt: Options, dataset: Optional[Dataset] = None,
                 verbose: bool = True) -> dict:
    """Full BayesRRm/FH chain with hydra-format outputs and restart."""
    ds = dataset if dataset is not None else dataset_from_options(opt)
    fh = opt.bayes_type == "bayesFHMPI"
    _autosize_exact_window(opt, ds.n)

    mcmc_out = opt.mcmc_out
    rd = None
    if opt.restart:
        rd = read_restart(mcmc_out, ds.m, ds.n, opt.save,
                          use_xfiles=opt.use_xfiles_in_restart,
                          covariates=opt.covariates)
        apply_restart_rng(opt, rd)
        # outputs renamed *_rs so the original files survive (BayesRRm.cpp:1206-1222)
        opt.mcmc_out_name += "_rs"
        mcmc_out = opt.mcmc_out

    sampler = BayesRRm(
        ds, window=opt.window, exact=opt.exact, fh=fh,
        shuffle=bool(opt.shuffle_markers), seed=opt.seed,
        n_devices=opt.n_devices, n_ind=opt.ind_shards,
        n_dcn=opt.dcn_slices, dtype=opt.dtype,
        cross_sync=opt.cross_sync, schedule=opt.schedule,
        det_sync=bool(opt.det_sync),
        fh_params=dict(v0L=opt.v0L, v0t=opt.v0t, v0c=opt.v0c,
                       s02c=opt.s02c, tau0=opt.tau0))

    if rd is not None:
        state = sampler.init_state_from_restart(rd)
        start_it = rd.start_iteration
    else:
        state = sampler.init_state()
        start_it = 0

    from hydra_tpu.outputs.writers import NullWriter
    from hydra_tpu.parallel.distributed import is_primary
    primary = is_primary()
    writer = McmcWriter(mcmc_out, ds.m, ds.n, ds.num_groups,
                        ds.mS.shape[1], opt.thin, opt.save, opt.seed,
                        covariates=opt.covariates,
                        window=opt.window, exact=opt.exact,
                        schedule=sampler.cfg.schedule) if primary else NullWriter()
    marker_order = sampler.slot_to_marker[sampler.slot_to_marker >= 0].astype(np.int32)

    # collective-cost profile for the reference's proc/sync telemetry
    # (BayesRRm.cpp:2713-2722; see utils/telemetry.py for methodology)
    prof = telemetry.measure_sync_profile(
        sampler.mesh, sampler.cfg.n_pad, sampler.cfg.n_windows,
        n_ind=sampler.cfg.n_ind) if verbose else telemetry.SyncProfile()

    tot_proc = 0.0
    stats = None
    for it, k in _iter_blocks(start_it, opt.chain_length, opt.thin,
                              opt.save, verbose):
        t0 = time.time()
        if k == 1:
            state, stats = sampler.step(state, it)
        else:
            # fused dispatch: iterations it-k+1 .. it in one lax.scan
            state, stats = sampler.run_steps(state, it - k + 1, k)
            stats = _last_stats(stats)
        on_thin = it % opt.thin == 0
        on_save = it > 0 and it % opt.save == 0
        on_log = verbose and it % 10 == 0
        if on_thin or on_save or on_log:
            pulls = dict(sigma_g=state.sigma_g, sigma_e=state.sigma_e,
                         mu=state.mu, m0=stats.m0)
            if on_thin or on_save:
                pulls.update(beta=state.beta, components=state.components)
            if on_thin:
                pulls.update(est_pi=state.est_pi, acum=state.acum)
            if on_save:
                pulls.update(eps=state.eps, gamma=state.gamma)
                if fh:
                    pulls.update(lambda_var=state.lambda_var,
                                 nu_var=state.nu_var, c_slab=state.c_slab,
                                 tau=state.tau, hyp_tau=state.hyp_tau)
            if on_log:
                pulls.update(beta_sqn=stats.beta_sqn, cass=stats.cass)
            h = _fetch_host(pulls)
        if on_thin or on_save:
            beta_g = sampler._to_marker_order(h["beta"].astype(np.float64))
            comp_g = sampler._to_marker_order(
                h["components"].astype(np.int64)).astype(np.int32)
        if on_thin:
            sg = h["sigma_g"].astype(np.float64)
            se = float(h["sigma_e"])
            m0 = int(h["m0"].sum())
            row = writer.csv_row_brr(it, sg, se, m0,
                                     h["est_pi"].astype(np.float64))
            writer.on_thin(it, beta_g, comp_g, row, float(h["mu"]),
                           acum=sampler._to_marker_order(
                               h["acum"].astype(np.float64)))
        if on_save:
            eps = h["eps"].astype(np.float64)[: ds.n]
            fh_state = None
            if fh:
                lam = np.zeros(ds.m)
                nu = np.zeros(ds.m)
                sel = sampler.slot_to_marker >= 0
                lam[sampler.slot_to_marker[sel]] = h["lambda_var"][sel]
                nu[sampler.slot_to_marker[sel]] = h["nu_var"][sel]
                fh_state = dict(lambda_var=lam, nu_var=nu,
                                c_slab=np.asarray(h["c_slab"]),
                                tau=float(h["tau"]),
                                hyp_tau=float(h["hyp_tau"]))
            writer.on_save(it, eps, marker_order, beta_g, comp_g,
                           gamma=h["gamma"].astype(np.float64),
                           x_order=(sampler.cov_order(it)
                                    if opt.covariates else None),
                           fh_state=fh_state)
        dt = time.time() - t0
        tot_proc += dt
        # the reference prints RESULT every iteration on rank%10==0 ranks;
        # the single logical rank here reports every 10th iteration so the
        # host<->device pull does not throttle the async dispatch chain
        if on_log and primary:
            sg = float(h["sigma_g"].sum())
            se = float(h["sigma_e"])
            print(telemetry.result_line(
                it, dt / k, prof, sg, se,
                float(h["beta_sqn"].sum()),
                int(h["m0"].sum())), flush=True)
            print(telemetry.cass_table(
                it, np.asarray(sampler.mtot_grp), h["sigma_g"],
                h["cass"]), flush=True)

    n_done = opt.chain_length - start_it
    if verbose and n_done > 0 and primary:
        print(telemetry.exit_line(tot_proc, prof, n_done), flush=True)

    return dict(state=state, stats=stats, sampler=sampler,
                total_seconds=tot_proc, mcmc_out=mcmc_out,
                sync_profile=prof)
