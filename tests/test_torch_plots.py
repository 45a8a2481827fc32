"""The repository's reference example through the port's CLI with its
plots on (``fit.plots`` left at its default), the nominal-PDF export
against the JAX package's, and the JAX CLI options that the port does
not run yet (and two it runs since).

The example's configuration (``examples/reference_example.json``) is
used as shipped but for ``nsteps``, cut to a few hundred; its MC tables
are ``examples/make_example.py``'s distributions drawn from the same
seed, at 20,000 rows a signal instead of 500,000, so that the CPU run
takes a few seconds.  The exported ``<signal>_pdf.npy`` must equal the
JAX package's export on the same tables exactly: both divide the same
float32 integer counts by the same float64 norm x bin volume, rounded
to float32.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.cli import main
from sxmc_tpu_torch.io import loaders

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NROWS = 20_000
NSTEPS = 300


def _write_tables(workdir: pathlib.Path) -> None:
    """examples/make_example.py's two signals, NROWS rows each."""
    rng = np.random.default_rng(1234)
    n = NROWS
    fields = ["energy", "mc_energy", "radius"]
    mc1 = rng.normal(10.0, 0.2, n).astype(np.float32)
    e1 = (mc1 + rng.normal(0, 0.8, n)).astype(np.float32)
    sig1 = np.stack([e1, mc1, rng.uniform(0, 10, n).astype(np.float32)], 1)
    mc2 = (5.0 + rng.exponential(3.0, n)).astype(np.float32)
    e2 = (mc2 + rng.normal(0, 0.8, n)).astype(np.float32)
    sig2 = np.stack([e2, mc2, rng.uniform(0, 10, n).astype(np.float32)], 1)
    loaders.write_float_table(str(workdir / "signal1.npz"), sig1, fields)
    loaders.write_float_table(str(workdir / "signal2.npz"), sig2, fields)


def _config(workdir: pathlib.Path) -> pathlib.Path:
    cfg = json.loads((REPO / "examples" /
                      "reference_example.json").read_text())
    assert "plots" not in cfg["fit"]  # left at its default, true
    cfg["fit"]["nsteps"] = NSTEPS
    path = workdir / "reference_example.json"
    path.write_text(json.dumps(cfg))
    return path


@pytest.fixture(scope="module")
def example_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("reference_example")
    _write_tables(workdir)
    cfg = _config(workdir)
    out = workdir / "out"
    rc = main([str(cfg), str(out), "--data-root", str(workdir), "--device",
               "cpu"])
    return workdir, cfg, out, rc


def test_reference_example_runs_with_plots(example_run):
    _, _, out, rc = example_run
    assert rc == 0
    recs = [json.loads(line) for line in
            (out / "example_metrics.jsonl").read_text().splitlines()]
    assert "experiment_failed" not in [r["event"] for r in recs]
    limit = [r for r in recs if r["event"] == "experiment_limit"]
    assert len(limit) == 1 and np.isfinite(limit[0]["upper"])
    # plot_fit's figure of the one dataset and observable, experiment 0.
    png = out / "fit_ds0_energy_0.png"
    assert png.exists() and png.stat().st_size > 0
    for name in ("signal1", "signal2"):
        dens = np.load(out / f"{name}_pdf.npy")
        assert dens.shape == (10,) and dens.dtype == np.float32
        assert np.isfinite(dens).all() and dens.sum() > 0


def test_pdf_export_matches_jax(example_run):
    """The JAX package's export (sxmc_tpu/ensemble.py:124-134) on the same
    configuration and tables, bit for bit."""
    from sxmc_tpu.fitconfig import FitConfig
    from sxmc_tpu.mcmc.metropolis import MCMC
    from sxmc_tpu.signal import nominal_params

    workdir, cfg, out, _ = example_run
    fc = FitConfig.from_json_file(str(cfg), data_root=str(workdir))
    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                binned=fc.binned)
    hists, norms = mcmc.stack.histograms(nominal_params(fc.systematics))
    hists, norms = np.asarray(hists), np.asarray(norms)
    for i, sig in enumerate(fc.signals):
        want = hists[i].reshape(mcmc.stack.nbins) / max(
            float(norms[i]) * mcmc.stack.bin_volume, 1e-30)
        np.testing.assert_array_equal(np.load(out / f"{sig.name}_pdf.npy"),
                                      want)


def test_plotting_failure_does_not_kill_the_fit(example_run, tmp_path,
                                                monkeypatch, capsys):
    from sxmc_tpu_torch import plots

    def broken(*args, **kwargs):
        raise RuntimeError("no display")

    monkeypatch.setattr(plots, "plot_fit", broken)
    workdir, cfg, _, _ = example_run
    cfg_small = json.loads(cfg.read_text())
    cfg_small["fit"]["nsteps"] = 100
    path = tmp_path / "small.json"
    path.write_text(json.dumps(cfg_small))
    out = tmp_path / "out"
    assert main([str(path), str(out), "--data-root", str(workdir),
                 "--device", "cpu"]) == 0
    assert "ensemble: plotting failed: no display" in capsys.readouterr().out
    recs = [json.loads(line) for line in
            (out / "example_metrics.jsonl").read_text().splitlines()]
    assert [r["event"] for r in recs].count("experiment_limit") == 1
    assert (out / "signal1_pdf.npy").exists()


@pytest.mark.parametrize("flag, item", [
    (["--profile", "logdir"], "item 7"),
    (["--process-id", "1"], "item 14"),
    (["--hypotest-band"], "item 10"),
    (["--hypotest-asymptotic"], "item 10")])
def test_jax_cli_options_raise_naming_their_item(tmp_path, flag, item):
    """Options of sxmc_tpu.cli that the port does not run raise
    NotImplementedError naming their ROADMAP item (not argparse's exit
    2).  The ported ones run, here beside the gradient MLE on the golden
    configuration: --hypotest-band alone adds nothing (the band needs
    --hypotest's toys, as in the JAX package), --hypotest-asymptotic
    writes the Asimov limit (item 10, the statistics tier)."""
    if item != "item 10":
        with pytest.raises(NotImplementedError,
                           match=f"{flag[0]} .*{item}\\)"):
            main(["config.json", str(tmp_path), "--device", "cpu"] + flag)
        return
    golden = REPO / "tests" / "data" / "golden"
    cfg = json.loads((golden / "config.json").read_text())
    cfg["fit"].update(nexperiments=1, output_format="npz")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    assert main([str(path), str(out), "--device", "cpu", "--data-root",
                 str(golden), "--sampler", "mle"] + flag) == 0
    mle = json.loads((out / "golden_mle_0.json").read_text())
    assert np.isfinite(mle["upper_limit"])
    hypotest = out / "golden_hypotest_0.json"
    if flag == ["--hypotest-band"]:
        assert not hypotest.exists()
    else:
        assert np.isfinite(json.loads(hypotest.read_text())[
            "asymptotic_limit"])
