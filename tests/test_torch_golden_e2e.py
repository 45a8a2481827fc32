"""The golden end-to-end fixture through the PyTorch port.

tests/data/golden/ runs through the port's whole fit (config parse,
PdfStack, the three-phase Metropolis chain, intervals, median limit)
with the JAX package's fake datasets and ``_presample`` noise streams
injected (``run_ensemble``'s ``dataset_fn`` / ``presampler_fn``).  The
summary numbers must then match the values FROZEN in
test_golden_e2e.py within that test's own tolerances (2e-3 relative,
0.5 on the NLL minimum): any difference in binning, sentinels, NLL
terms, proposals, retuning, accept rule or interval math moves them far
outside.

A second run uses the port's own torch RNG through the CLI; it must
complete and write its ``npz`` outputs.
"""

import json
import os

import numpy as np
import pytest
import jax
import torch

from test_golden_e2e import FROZEN_BEST, FROZEN_LIMITS, FROZEN_NLL_MIN, \
    GOLDEN
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them (with one thread per core
# in every worker these tests ran ten times slower under xdist).
torch.set_num_threads(1)


def _jax_inputs():
    """Per experiment: the JAX ensemble's dataset and the three phase
    streams its single chain draws (ensemble.py:371, metropolis.py:
    203-205, 1265, 1255-1257)."""
    from sxmc_tpu.fitconfig import FitConfig
    from sxmc_tpu.generator import make_fake_dataset
    from sxmc_tpu.mcmc import metropolis as jm

    fc = FitConfig.from_json_file(os.path.join(GOLDEN, "config.json"),
                                  data_root=GOLDEN)
    mcmc = jm.MCMC(fc.sources, fc.signals, fc.systematics, fc.observables)
    nburn = int(fc.nsteps * fc.burnin_fraction)
    lengths = (nburn, nburn, fc.nsteps - 2 * nburn)
    key = jax.random.PRNGKey(fc.seed)
    # As the JAX runner draws them: inside jit (one compile per length).
    presample = jax.jit(jm._presample, static_argnums=(1, 2))
    datasets, streams = [], []
    for i in range(fc.nexperiments):
        exp_key = jax.random.fold_in(key, i)
        datasets.append(np.asarray(make_fake_dataset(
            exp_key, fc.signals, fc.systematics, fc.observables,
            poisson=True, stack=mcmc.stack)))
        chain_key = jax.random.split(exp_key, 1)[0]
        phases = []
        for k, n in zip(jax.random.split(chain_key, 3), lengths):
            noise, u = presample(jax.random.split(k, n),
                                 mcmc.nparameters, 0)
            phases.append((np.asarray(noise), np.asarray(u)))
        streams.append(phases)
    return datasets, streams


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    from sxmc_tpu_torch import interop
    from sxmc_tpu_torch.ensemble import run_ensemble
    from sxmc_tpu_torch.fitconfig import FitConfig

    datasets, streams = _jax_inputs()
    fc = FitConfig.from_json_file(os.path.join(GOLDEN, "config.json"),
                                  data_root=GOLDEN)
    fc.output_format = "npz"
    out = str(tmp_path_factory.mktemp("torch_golden"))
    limits = run_ensemble(
        fc, out, device="cpu", verbose=False,
        dataset_fn=lambda i: interop.dataset(datasets[i]),
        presampler_fn=lambda i: interop.presampler(streams[i]))
    return limits, out


class TestGoldenThroughPort:
    def test_limits(self, golden_run):
        limits, _ = golden_run
        np.testing.assert_allclose(limits, FROZEN_LIMITS, rtol=2e-3)

    def test_best_fit_and_intervals(self, golden_run):
        from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

        _, out = golden_run
        bf = LikelihoodSpace.load(os.path.join(out, "golden_0.npz")
                                  ).get_best_fit()
        assert set(bf) == set(FROZEN_BEST)
        for name, (pt, lo, up) in FROZEN_BEST.items():
            iv = bf[name]
            assert abs(iv.point_estimate - pt) < 2e-3 * max(abs(pt), 0.02)
            assert abs(iv.lower - lo) < 2e-3 * max(abs(lo), 0.02)
            assert abs(iv.upper - up) < 2e-3 * max(abs(up), 0.02)

    def test_nll_min(self, golden_run):
        from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

        _, out = golden_run
        ls = LikelihoodSpace.load(os.path.join(out, "golden_0.npz"))
        assert ls.nll_min == pytest.approx(FROZEN_NLL_MIN, abs=0.5)

    def test_metrics_stream(self, golden_run):
        _, out = golden_run
        with open(os.path.join(out, "golden_metrics.jsonl")) as f:
            events = [json.loads(line)["event"] for line in f]
        assert events.count("experiment_fit") == 2
        assert "experiment_failed" not in events
        assert events[-1] == "ensemble_done"


def test_cli_on_port_rng(tmp_path):
    """One experiment on the port's own RNG, through the CLI."""
    from sxmc_tpu_torch.cli import main

    with open(os.path.join(GOLDEN, "config.json")) as f:
        cfg = json.load(f)
    cfg["fit"].update(nexperiments=1, nsteps=1000, output_format="npz")
    for sig in cfg["signals"].values():
        sig["filename"] = os.path.join(GOLDEN, sig["filename"])
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    assert main([str(path), str(out), "--device", "cpu"]) == 0
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    ls = LikelihoodSpace.load(str(out / "golden_0.npz"))
    assert ls.samples.shape == (600, 3)
    assert np.isfinite(ls.nll_values).all()
    upper = ls.get_best_fit()["signal1"].upper
    assert 0.5 < upper < 2.0
    with open(out / "golden_metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    fit = [r for r in recs if r["event"] == "experiment_fit"][0]
    assert 0.02 < fit["accept_rate"] < 0.95
