"""sxmc_tpu_torch's goodness of fit, pull study, batched toy generator and
the frequentist tier's CLI against the JAX package.

The inputs are test_torch_mle's; the JAX package's answers and the toy
batches it drew are stored by ``tests/data/stats_reference/
make_reference.py`` (with the golden configuration's CLI runs: their
fake datasets and JSON outputs) and the toys are fed to the port in the
same order.  Tolerances: chi2 1e-5 relative, ndof equal, the asymptotic
p-value 1e-6; pulls 1e-3; the toy generator (another RNG) within 4
sigma of its expectation; the CLI's limits 1e-3 relative.
"""

import json

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.fitconfig import FitConfig
from sxmc_tpu_torch.generator import make_fake_dataset_batch
from sxmc_tpu_torch.stats.bias import pull_study
from sxmc_tpu_torch.stats.gof import baker_cousins_chi2, goodness_of_fit

from test_torch_hypotest import stored_toys
from test_torch_mle import GEN, REF, REF_DIR, port_mle
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


def test_baker_cousins_chi2_matches_jax():
    from sxmc_tpu.stats.gof import baker_cousins_chi2 as j_chi2

    rng = np.random.default_rng(17)
    mu = rng.uniform(0.0, 20.0, (2, 30))
    mu[0, :3] = 0.0
    n = rng.poisson(mu).astype(np.float64)
    n[1, :2] = 0.0
    n[0, 0] = 3.0  # an event where the model has none
    assert baker_cousins_chi2(n, mu) == pytest.approx(j_chi2(n, mu),
                                                      rel=1e-5)


def test_goodness_of_fit_matches_jax():
    """A toy of the model as the data (its padding rows read as no
    dataset), its generating parameters as the best fit; refit toys
    (the JAX package's, injected) against their own fitted
    expectation."""
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch",
                                               n_mc=GEN.N_MC)
    g = goodness_of_fit(srcs, sigs, systs, obs, REF["dnll_toys"][0],
                        GEN.GOF_PARAMS, ntoys=GEN.NTOYS, refit=True,
                        device="cpu", toys=stored_toys("gof_toys_"))
    assert g.chi2 == pytest.approx(float(REF["gof_chi2"]), rel=1e-5)
    assert g.ndof == int(REF["gof_ndof"])
    assert abs(g.p_asymptotic - float(REF["gof_p_asym"])) <= 1e-6
    np.testing.assert_allclose(g.chi2_toys, REF["gof_chi2_toys"], rtol=1e-3)


def test_pull_study_matches_jax():
    ps = pull_study(port_mle(), GEN.NTOYS, None,
                    toys=stored_toys("pull_toys_"))
    np.testing.assert_allclose(ps.estimates, REF["pull_estimates"],
                               rtol=1e-3)
    np.testing.assert_allclose(ps.errors, REF["pull_errors"], rtol=1e-3)
    want = (REF["pull_estimates"] - 1.0) / REF["pull_errors"]
    np.testing.assert_allclose(ps.pulls, want, rtol=0, atol=1e-3 * np.abs(
        want).max() + 1e-3)


@pytest.mark.parametrize("fluctuate", [False, True])
def test_toy_batch_counts(fluctuate):
    """The port's toys (its own RNG): per dataset, the mean count over the
    toys within 4 sigma of the expectation; events inside the bounds,
    padding tagged -1; fluctuated systematics past the 32 thetas of one
    B1-batched launch."""
    mle = port_mle()
    st = mle.stack
    ntoys = 40
    rates = {"a": 0.5, "b": 1.0, "c": 2.0}
    gen = torch.Generator().manual_seed(3)
    batch = make_fake_dataset_batch(gen, mle.signals, mle.systematics,
                                    mle.observables, ntoys, st, rates=rates,
                                    fluctuate_systematics=fluctuate)
    assert batch.shape[0] == ntoys and batch.dtype == torch.float32
    tags = batch[..., -1]
    x = batch[..., 0][tags >= 0]
    assert bool(((x >= 5.0) & (x < 15.0)).all())
    assert set(torch.unique(tags).tolist()) <= {-1.0, 0.0, 1.0}
    _, norms = st.histograms(np.zeros(2, np.float32))
    for ds in (0, 1):
        mu = sum(rates[s.name] * s.nexpected * float(norms[j]) / s.n_mc
                 for j, s in enumerate(mle.signals) if s.dataset == ds)
        mean = float((tags == ds).sum(dim=1).double().mean())
        # Fluctuated efficiencies widen the spread: allow for them.
        sigma = np.sqrt(mu / ntoys) * (3.0 if fluctuate else 1.0)
        assert abs(mean - mu) <= 4 * sigma, (ds, mean, mu)


def test_counts_from_read_bins_batched():
    """One offset bincount over a batch of toys equals the per-toy
    counts; weights are summed per bin."""
    mle = port_mle()
    st = mle.stack
    data = np.stack([make_data(seed=s, nev=300) for s in (1, 2, 3)])
    rb = st.compute_read_bins(data)
    got = st.counts_from_read_bins(rb)
    for t in range(3):
        assert torch.equal(got[t], st.data_bin_counts(data[t]))
    w = torch.arange(300, dtype=torch.float32) / 7
    one = st.counts_from_read_bins(rb[0], w)
    want = torch.zeros_like(one)
    rb0 = rb[0]
    for d, ds in enumerate(st.unique_datasets):
        row = rb0[st.datasets.index(ds)]
        want[d].index_add_(0, row[row >= 0].long(), w[row >= 0])
    torch.testing.assert_close(one, want, rtol=1e-6, atol=1e-5)


def cli_run(tmp_path, tag, **kw):
    """The port's ensemble on the golden configuration fed the JAX run's
    fake dataset; returns (port outputs, JAX outputs)."""
    from sxmc_tpu_torch.ensemble import run_ensemble

    ref = json.loads((REF_DIR / f"cli_{tag}.json").read_text())
    golden = REF_DIR.parent / "golden"
    cfg = json.loads((golden / "config.json").read_text())
    cfg["fit"].update(nexperiments=1, nsteps=GEN.CLI_STEPS,
                      output_format="npz")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    fc = FitConfig.from_json_file(str(path), data_root=str(golden))
    out = tmp_path / "out"
    data = np.asarray(ref["dataset"], np.float32)
    limits = run_ensemble(fc, str(out), device="cpu", verbose=False,
                          max_retries=0, dataset_fn=lambda i: data, **kw)
    got = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}
    assert len(limits) == 1 and np.isfinite(limits[0])
    return got, ref


def test_cli_mle_gof_asymptotic_matches_jax(tmp_path):
    got, ref = cli_run(tmp_path, "mle", sampler="mle", gof_toys=0,
                       hypotest_asymptotic=True)
    mle, want = got["golden_mle_0.json"], ref["golden_mle_0.json"]
    assert mle["upper_limit"] == pytest.approx(want["upper_limit"], rel=1e-3)
    assert abs(mle["nll"] - want["nll"]) <= 1e-3
    assert mle["converged"] == want["converged"]
    for name in ("signal1", "signal2"):
        assert mle["params"][name] == pytest.approx(want["params"][name],
                                                    rel=1e-3)
    ht, want = got["golden_hypotest_0.json"], ref["golden_hypotest_0.json"]
    for key in ("profile_limit", "asymptotic_limit"):
        assert ht[key] == pytest.approx(want[key], rel=1e-3)
    for n, v in want["asymptotic_expected"].items():
        assert ht["asymptotic_expected"][n] == pytest.approx(v, rel=1e-3)
    assert abs(ht["q0"] - want["q0"]) <= 2e-3


def test_cli_hypotest_bias_matches_jax(tmp_path):
    """Beside the Metropolis fit, with toys of the port's own RNG: the
    deterministic outputs match, the toy ones are finite."""
    got, ref = cli_run(tmp_path, "metropolis", hypotest_toys=8,
                       bias_toys=8)
    ht, want = got["golden_hypotest_0.json"], ref["golden_hypotest_0.json"]
    assert ht["profile_limit"] == pytest.approx(want["profile_limit"],
                                                rel=1e-3)
    assert abs(ht["q0"] - want["q0"]) <= 2e-3
    # The coarse grid (from the profile limit) is in both; the
    # refinement points depend on the toys.
    hi = max(2.0 * want["profile_limit"], 1e-2)
    for r in np.linspace(hi / 8.0, hi, 8):
        assert np.min(np.abs(np.asarray(ht["r_grid"]) - r)) <= 1e-3 * r
    assert np.isfinite(ht["cls_limit"]) and ht["ntoys"] == 8
    pulls, want = got["golden_pulls.json"], ref["golden_pulls.json"]
    assert (pulls["ntoys"], pulls["cl"]) == (want["ntoys"], want["cl"])
    assert sorted(pulls["summary"]) == sorted(want["summary"])
    for s in pulls["summary"].values():
        assert s["n_used"] == 8 and np.isfinite(s["pull_mean"])


def test_unported_options_still_raise(tmp_path):
    from sxmc_tpu_torch.cli import main

    for flags, err in ((["--sampler", "nuts"], NotImplementedError),
                       (["--checkpoint-steps", "10"], NotImplementedError),
                       (["--sharded", "--sampler", "mle"], ValueError),
                       (["--sharded", "--hypotest", "8"], ValueError)):
        with pytest.raises(err):
            main(["config.json", str(tmp_path), "--device", "cpu"] + flags)
