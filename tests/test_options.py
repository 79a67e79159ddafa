"""Option parsing / validation rules, incl. the fast faithful defaults.

Exact mode is window-invariant (test_bayesrrm.py::
test_exact_mode_is_exact_across_shards), so the default CLI run must take
the fused Pallas path (window >= 8) instead of a per-marker scan; BayesW
stale windows > 64 are measurably biased (BIAS_SWEEP_BW.md) and must warn.
"""

from hydra_tpu.options import parse_args


def test_exact_default_window_is_64(capsys):
    opt = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                      "--pheno", "x.phen"])
    assert opt.exact and opt.sync_rate == 1
    assert opt.window == 64
    assert "window=64" in capsys.readouterr().out


def test_exact_explicit_window_respected():
    opt = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                      "--pheno", "x.phen", "--window", "16"])
    assert opt.window == 16


def test_stale_window_follows_sync_rate():
    opt = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                      "--pheno", "x.phen", "--stale", "--sync-rate", "32"])
    assert not opt.exact
    assert opt.window == 32


def test_bayesw_default_window_follows_sync_rate():
    # BayesW has no exact Gram mode and its windows are NOT invariant
    # (BIAS_SWEEP_BW.md) — the default stays tied to --sync-rate.
    opt = parse_args(["--mpibayes", "bayesWMPI", "--bfile", "x",
                      "--pheno", "x.phen", "--failure", "x.fail",
                      "--sync-rate", "8"])
    assert opt.window == 8


def test_bayesw_wide_window_warns(capsys):
    opt = parse_args(["--mpibayes", "bayesWMPI", "--bfile", "x",
                      "--pheno", "x.phen", "--failure", "x.fail",
                      "--window", "256"])
    assert opt.window == 256          # warned, not clamped
    assert "BIAS_SWEEP_BW" in capsys.readouterr().out


def test_bayesw_window_64_no_warning(capsys):
    parse_args(["--mpibayes", "bayesWMPI", "--bfile", "x",
                "--pheno", "x.phen", "--failure", "x.fail",
                "--window", "64"])
    assert "BIAS_SWEEP_BW" not in capsys.readouterr().out


def test_exact_window_autosizes_at_wide_n(capsys):
    """The defaulted exact window is sized once N is known
    (runner._autosize_exact_window): W=128 above N=16384. A user-passed
    --window is never touched, nor is stale mode."""
    from hydra_tpu.runner import _autosize_exact_window
    opt = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                      "--pheno", "x.phen"])
    assert opt.window_auto
    _autosize_exact_window(opt, 5000)
    assert opt.window == 64                 # small N keeps 64
    _autosize_exact_window(opt, 50000)
    assert opt.window == 128
    assert "auto-sized to 128" in capsys.readouterr().out
    explicit = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                           "--pheno", "x.phen", "--window", "64"])
    _autosize_exact_window(explicit, 50000)
    assert explicit.window == 64 and not explicit.window_auto
    stale = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                        "--pheno", "x.phen", "--stale", "--sync-rate", "64"])
    _autosize_exact_window(stale, 50000)
    assert stale.window == 64


def test_restart_adopts_saved_window_when_auto(capsys):
    """An auto-sized window yields to the saved chain's schedule on restart
    (bitwise faithfulness beats the speed default)."""
    from types import SimpleNamespace
    from hydra_tpu.runner import apply_restart_rng
    opt = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                      "--pheno", "x.phen"])
    rd = SimpleNamespace(seed=7, rng_window=128, rng_exact=True,
                         rng_schedule="block")
    apply_restart_rng(opt, rd)
    assert opt.window == 128 and opt.seed == 7
    assert opt.schedule == "block"          # auto adopts the saved schedule
    out = capsys.readouterr().out
    assert "adopting the saved chain's window" in out
    assert "adopting the saved chain's 'block' schedule" in out
    assert "WARNING" not in out
    explicit = parse_args(["--mpibayes", "bayesMPI", "--bfile", "x",
                           "--pheno", "x.phen", "--window", "32"])
    apply_restart_rng(explicit, rd)
    assert explicit.window == 32            # user choice wins, with a warning
    assert "WARNING" in capsys.readouterr().out
