"""Lock-step chains: kernels B1, B3 and B4 in their batched forms, and
the batched runner, against the JAX package on identical inputs.

* The plain versions of B1-batched, B3-batched and B4-batched against
  the JAX Pallas kernels in interpret mode (a PdfStack built under
  ``force_pallas_interpret``), 3 chains: counts exact, |dNLL| <= 1e-3
  (NLL_TOL, as test_torch_kernels.py: XLA's CPU log vs torch's,
  compensated float32 pairs vs float64 sums), and, fed the same
  noise, identical accept decisions with parameters within 1e-6
  relative (XLA may contract a proposal into an FMA).
* ``run_chain(..., nchains=3)`` against ``_run_chains_batched`` fed the
  JAX ``phase_xs`` streams through ``interop``: per-chain retuning,
  chain-major pooling.  With floating systematics the port takes the
  fused route (accept ``log(u) <= delta``) and the JAX CPU stack its
  scan stepper (``u <= exp(delta)``): they decide alike except within
  rounding of that boundary.  With fixed systematics both take the
  stepper.
* ``run_ensemble`` end to end with 2 chains and with fixed
  systematics, on tests/data/golden/.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them.
torch.set_num_threads(1)

NLL_TOL = 1e-3
NCH = 3
NSTEPS = 8
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")

THETAS = np.asarray([[0.0, 0.0], [0.011, -0.006], [-0.03, 0.009]],
                    np.float32)
PARAMS = np.asarray([[1.0, 1.0, 1.0, 0.0, 0.0],
                     [1.2, 0.85, 1.05, 0.011, -0.006],
                     [-0.1, 1.0, 1.0, 0.0, 0.0]], np.float32)


@pytest.fixture(scope="module")
def pallas_pair():
    from sxmc_tpu.pdf.stack import force_pallas_interpret

    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu")
    with force_pallas_interpret():
        jmc = jm.MCMC(srcs, sigs, systs, obs)
    assert jmc.stack.supports_fused
    jmc.stack.set_data(make_data())
    tmc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch"), device="cpu")
    tmc.stack.set_data(make_data())
    return jmc, tmc


def test_plain_histogram_batched_matches_pallas(pallas_pair):
    jmc, tmc = pallas_pair
    jh, jn = jmc.stack.histograms_batch(jnp.asarray(THETAS))
    th, tn = tmc.stack.histograms_batch(torch.as_tensor(THETAS))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for c in range(NCH):  # each chain is its own single build
        h, n = tmc.stack.histograms(torch.as_tensor(THETAS[c]))
        assert torch.equal(h, th[c]) and torch.equal(n, tn[c])


def test_plain_fused_nll_batched_matches_pallas(pallas_pair):
    jmc, tmc = pallas_pair
    js = jmc.stack
    jhi, jlo = js.fused_nll_pair(jnp.asarray(PARAMS), js._read_bins,
                                 js.device_data, jmc.static)
    thi, tlo = tmc.stack.fused_nll_pair_batch(torch.as_tensor(PARAMS),
                                              tmc.stack.read_bins,
                                              tmc.nll_spec)
    assert thi.shape == (NCH,)
    want = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    np.testing.assert_allclose(thi.double().numpy() + tlo.double().numpy(),
                               want, rtol=0, atol=NLL_TOL)
    assert float(thi[2]) == float(np.float32(1e18))  # negative rate
    for c in range(NCH):
        h, l = tmc.stack.fused_nll_pair(torch.as_tensor(PARAMS[c]),
                                        tmc.stack.read_bins, tmc.nll_spec)
        assert (float(h), float(l)) == (float(thi[c]), float(tlo[c]))


def test_plain_segment_batched_matches_pallas(pallas_pair):
    jmc, tmc = pallas_pair
    js = jmc.stack
    rng = np.random.default_rng(23)
    p0 = np.tile(jmc.parameter_means, (NCH, 1)).astype(np.float32)
    w0 = np.tile(jmc.initial_jump_widths(), (NCH, 1)).astype(np.float32)
    w0[1] *= 2.0  # chains walk with their own widths
    noise = rng.normal(0, 1, (NSTEPS, NCH, len(p0[0]))).astype(np.float32)
    log_u = np.log(rng.uniform(0, 1, (NSTEPS, NCH))).astype(np.float32)
    jhi, jlo = js.fused_nll_pair(jnp.asarray(p0), js._read_bins,
                                 js.device_data, jmc.static)
    j_s, j_n, j_a = js.fused_segment(
        jnp.asarray(p0), (jhi, jlo), jnp.asarray(w0), js._read_bins,
        js.device_data, jnp.asarray(noise), jnp.asarray(log_u), jmc.static)
    nll0 = torch.as_tensor(np.stack([np.asarray(jhi), np.asarray(jlo)],
                                    axis=-1))
    t_s, t_n, t_a = tmc.stack.fused_segment_batch(
        torch.as_tensor(p0), nll0, torch.as_tensor(w0),
        tmc.stack.read_bins, torch.as_tensor(noise),
        torch.as_tensor(log_u), tmc.nll_spec)
    assert t_s.shape == (NSTEPS, NCH, 5) and t_a.shape == (NSTEPS, NCH)
    np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(t_n.double().sum(-1).numpy(),
                               np.asarray(j_n, np.float64).sum(-1), rtol=0,
                               atol=NLL_TOL)
    assert 0 < t_a.sum() < NSTEPS * NCH
    # Chain 0 walks as it would alone.
    s0, n0, a0 = tmc.stack.fused_segment(
        torch.as_tensor(p0[0]), nll0[0], torch.as_tensor(w0[0]),
        tmc.stack.read_bins, torch.as_tensor(noise[:, 0].copy()),
        torch.as_tensor(log_u[:, 0].copy()), tmc.nll_spec)
    assert torch.equal(s0, t_s[:, 0]) and torch.equal(a0, t_a[:, 0])


@functools.partial(jax.jit, static_argnums=(1, 2))
def _phase_xs_jit(ks, n, npar):
    split = jax.vmap(lambda k: jax.random.split(k, 2 * n).reshape(
        n, 1, 2, -1))(ks)
    noise = jax.vmap(jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (npar,)))))(split[:, :, :, 0])
    u = jax.vmap(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, ()))))(split[:, :, :, 1])
    return jnp.moveaxis(noise, 0, 1), jnp.moveaxis(u, 0, 1)


def _phase_xs(ks, n, npar):
    """_run_chains_batched's phase_xs (metropolis.py:1102-1114), m = 0,
    drawn under jit as the JAX runner draws them (op by op every new
    shape compiles anew)."""
    return tuple(np.asarray(x) for x in _phase_xs_jit(ks, n, npar))


@pytest.mark.parametrize("fixed", [False, True])
def test_batched_runner_fed_jax_streams(fixed):
    nsteps, burnin = 30, 6
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu")
    tsrcs, tsigs, tsysts, tobs = make_stack_inputs("sxmc_tpu_torch")
    for s in (systs + tsysts if fixed else []):
        s.fixed = True
    jmc = jm.MCMC(srcs, sigs, systs, obs)
    jmc.stack.set_data(make_data())
    tmc = tm.MCMC(tsrcs, tsigs, tsysts, tobs, device="cpu")
    tmc.stack.set_data(make_data())
    assert tm._fused_ok(tmc) is not fixed

    keys = jax.random.split(jax.random.PRNGKey(31), NCH)
    js, (jhi, jlo), jacc = jm._run_chains_batched(
        jmc, keys, jmc.stack._read_bins, jmc.stack.device_data, nsteps,
        burnin, False)
    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    lengths = (burnin, burnin, nsteps - 2 * burnin)
    streams = [_phase_xs(keys3[:, p], n, jmc.nparameters)
               for p, n in enumerate(lengths)]
    ts, (thi, tlo), tacc = tm.run_chain(
        tmc, tmc.stack.read_bins, nsteps, burnin, False,
        interop.presampler(streams), nchains=NCH)
    nkeep = nsteps - 2 * burnin
    assert ts.shape == (NCH * nkeep, tmc.nparameters)
    np.testing.assert_allclose(ts.numpy().reshape(NCH, nkeep, -1),
                               np.asarray(js), rtol=1e-6, atol=1e-7)
    want = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    got = (thi.double() + tlo.double()).numpy().reshape(NCH, nkeep)
    np.testing.assert_allclose(got, want, rtol=0, atol=NLL_TOL)
    assert float(tacc) == pytest.approx(float(np.mean(jacc)), abs=1e-6)


def _golden_config(tmp_path, **fit):
    with open(os.path.join(GOLDEN, "config.json")) as f:
        cfg = json.load(f)
    cfg["fit"].update(nexperiments=1, nsteps=300, output_format="npz",
                      **fit)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


@pytest.mark.parametrize("variant", ["nchains=2", "fixed"])
def test_run_ensemble_golden(tmp_path, variant):
    from sxmc_tpu_torch.ensemble import run_ensemble
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    nchains = 2 if variant == "nchains=2" else 1
    cfg, path = _golden_config(tmp_path, nchains=nchains)
    fc = FitConfig.from_json_file(path, data_root=GOLDEN)
    if variant == "fixed":
        for s in fc.systematics:
            s.fixed = True
    out = str(tmp_path / "out")
    limits = run_ensemble(fc, out, device="cpu", verbose=False)
    assert len(limits) == 1 and np.isfinite(limits[0])
    ls = LikelihoodSpace.load(os.path.join(out, "golden_0.npz"))
    assert ls.samples.shape == (nchains * 180, 3)
    assert np.isfinite(ls.nll_values).all()
    if variant == "fixed":  # the pinned scale never moves
        assert (ls.samples[:, 2] == 0.0).all()
    with open(os.path.join(out, "golden_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert "experiment_failed" not in [r["event"] for r in recs]
    fit = [r for r in recs if r["event"] == "experiment_fit"][0]
    assert fit["nchains"] == nchains
    assert fit["steps_per_sec"] == pytest.approx(
        300 * nchains / fit["wall_seconds"])
    res = [r for r in recs if r["event"] == "experiment_result"][0]
    assert set(res["rhat"]) == set(ls.names)
