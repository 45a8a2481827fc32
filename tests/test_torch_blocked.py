"""Blocked Metropolis-within-Gibbs (``rate_substeps``): kernel B5 and the
blocked runners against the JAX package on identical inputs.

* The plain version of B5 (one chain, and three lock-step chains; M = 2
  rate moves per cycle) against the JAX Pallas kernel
  ``fused_segment_blocked`` in interpret mode (a PdfStack built under
  ``force_pallas_interpret``), fed the same noise: identical per-cycle
  accepted fractions, parameters within 1e-6 relative (XLA may contract
  a proposal into an FMA), |dNLL| <= 1e-3 (NLL_TOL, as
  test_torch_kernels.py).
* ``MCMC(..., rate_substeps=2)`` fed the JAX streams through ``interop``
  against ``_run_single_chain`` / ``_run_chains_batched``.  Binned, both
  take the blocked stepper (accept ``u <= exp(delta)``): step for step,
  NLLs within NLL_TOL.  Unbinned with floating systematics the port
  takes B5's plain version (accept ``log(u) <= delta``) and the JAX CPU
  stack its blocked stepper: they decide alike except within rounding
  of that boundary.
* Fixed systematics with ``rate_substeps > 0`` fall back to the joint
  step, as in the JAX package; ``run_ensemble`` end to end on
  tests/data/golden/, binned with three chains among them.
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

from test_torch_fullcov import same_walk
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them.
torch.set_num_threads(1)

NLL_TOL = 1e-3
M = 2
NCYCLES = 8
N_MC = 1000  # MC rows per signal of the Pallas-interpret stacks
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _phase_xs_blocked(ks, n, npar, m):
    """_run_chains_batched's phase_xs (metropolis.py:1102-1114) with m
    rate moves: noise (n, nchains, m + 1, npar), u (n, nchains, m + 1);
    under jit, as the JAX runner draws them (op by op every new shape
    compiles anew)."""
    kpc = 2 * (m + 1)
    split = jax.vmap(lambda k: jax.random.split(k, kpc * n).reshape(
        n, m + 1, 2, -1))(ks)
    noise = jax.vmap(jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (npar,)))))(split[:, :, :, 0])
    u = jax.vmap(jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, ()))))(split[:, :, :, 1])
    return jnp.moveaxis(noise, 0, 1), jnp.moveaxis(u, 0, 1)


_presample = jax.jit(jm._presample, static_argnums=(1, 2))


def _streams(key, nch, lengths, npar, m):
    """The JAX runners' per-phase streams: _run_single_chain's
    ``_presample(split(k, n), npar, m)`` for one chain,
    _run_chains_batched's phase_xs for several."""
    chain_keys = jax.random.split(key, nch)
    if nch == 1:
        return [tuple(np.asarray(x) for x in _presample(
                    jax.random.split(k, n), npar, m))
                for k, n in zip(jax.random.split(chain_keys[0], 3),
                                lengths)]
    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(chain_keys)
    return [tuple(np.asarray(x) for x in _phase_xs_blocked(
                keys3[:, p], n, npar, m))
            for p, n in enumerate(lengths)]


@pytest.mark.parametrize("nch,binned", [(1, False), (3, False), (3, True)])
def test_mcmc_blocked_fed_jax_streams(nch, binned):
    nsteps, frac = 42, 0.34  # three phases of 14: one stream compile
    burnin = int(nsteps * frac)
    lengths = (burnin, burnin, nsteps - 2 * burnin)
    jmc = jm.MCMC(*make_stack_inputs("sxmc_tpu"), binned=binned)
    tmc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch"), device="cpu",
                  binned=binned)
    assert tm._blocked_enabled(tmc, M)
    assert tm._fused_ok(tmc) is not binned
    key = jax.random.PRNGKey(27 + nch)
    jls = jmc(make_data(), nsteps, frac, key=key, nchains=nch,
              rate_substeps=M)
    streams = _streams(key, nch, lengths, jmc.nparameters, M)
    tls = tmc(make_data(), nsteps, frac, nchains=nch, rate_substeps=M,
              presampler=interop.presampler(streams))
    assert tls.samples.shape == (nch * lengths[2], tmc.nparameters)
    if binned:  # the same stepper on both sides: step for step
        np.testing.assert_allclose(tls.samples, jls.samples, rtol=1e-6,
                                   atol=1e-7)
    else:
        same_walk(tls.samples, jls.samples, nch)
    np.testing.assert_allclose(tls.nll_values, jls.nll_values, rtol=0,
                               atol=NLL_TOL)
    assert tmc.last_accept_rate == pytest.approx(jmc.last_accept_rate,
                                                 abs=1e-6)


def test_fixed_systematics_take_the_joint_step():
    """With every systematic fixed a rate move would rebuild nothing
    anyway: rate_substeps is ignored and the joint stepper runs on
    joint-step streams (metropolis.py:783-788), step for step the walk
    without it."""
    tin = make_stack_inputs("sxmc_tpu_torch")
    for s in tin[2]:
        s.fixed = True
    tmc = tm.MCMC(*tin, device="cpu")
    assert not tm._blocked_enabled(tmc, M) and tm._blocked_enabled(
        tm.MCMC(*make_stack_inputs("sxmc_tpu_torch"), device="cpu"), M)
    runs = []
    for m in (M, 0):
        ls = tmc(make_data(), 30, 0.2, rate_substeps=m,
                 generator=torch.Generator().manual_seed(6))
        runs.append((ls.samples, ls.nll_values, tmc.last_accept_rate))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert (runs[0][0][:, 3:] == 0.0).all()
    n, u = tm.presample(torch.Generator().manual_seed(1), 4, 5, "cpu",
                        nchains=3, m=M)
    assert n.shape == (4, M + 1, 3, 5) and u.shape == (4, M + 1, 3)


@pytest.mark.parametrize("variant", ["rate_substeps=2",
                                     "rate_substeps=2,binned,nchains=3"])
def test_run_ensemble_golden_blocked(tmp_path, variant):
    from sxmc_tpu_torch.cli import main
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    nchains = 3 if "nchains" in variant else 1
    with open(os.path.join(GOLDEN, "config.json")) as f:
        cfg = json.load(f)
    cfg["fit"].update(nexperiments=1, nsteps=200, output_format="npz",
                      nchains=nchains)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    flags = ["--rate-substeps", "2"] + (["--binned"] if "binned" in variant
                                        else [])
    assert main([str(path), str(out), "--device", "cpu", "--data-root",
                 GOLDEN] + flags) == 0
    ls = LikelihoodSpace.load(str(out / "golden_0.npz"))
    assert ls.samples.shape == (nchains * 120, 3)
    assert np.isfinite(ls.nll_values).all()
    recs = [json.loads(line) for line in
            (out / "golden_metrics.jsonl").read_text().splitlines()]
    assert "experiment_failed" not in [r["event"] for r in recs]
    fit = [r for r in recs if r["event"] == "experiment_fit"][0]
    assert fit["steps_per_sec"] == pytest.approx(
        200 * nchains / fit["wall_seconds"])
    assert 0.02 < fit["accept_rate"] < 0.95
    limit = [r for r in recs if r["event"] == "experiment_limit"][0]
    assert np.isfinite(limit["upper"])
