"""Parallel tempering: B4's tempered form and the tempered runners
against the JAX package on identical inputs.

* The plain version of B4-tempered against the JAX Pallas kernel
  ``pallas_fused_segment(beta=...)`` in interpret mode: here through the
  fused-route runner (unweighted), and kernel against kernel on a
  weighted stack in test_torch_weighted.py (one interpret-mode
  compilation covers both forms there).
* The fused-route runner (floating systematics: one B4-tempered launch
  per swap interval) and the stepper-route runner (fixed systematics,
  with the two burn-in phases and their retunes) against the JAX
  ``_run_tempered`` fed the same streams (the JAX key derivation of
  ``_make_tempered_fused_phase.interval_xs`` and of
  ``_make_tempered_step.phase_keys``): the cold chain's samples step by
  step within 1e-5 relative (the retune takes the RMS in float64 here,
  in float32 there: an ulp apart), its NLLs within NLL_TOL, the same
  accept rate and exactly the same swap rate.  The fused case runs the
  main phase alone: each Pallas call site of the JAX runner costs
  seconds of interpret-mode compilation.
* ``temperature_ladder``, one and two replicas, ``debug_mode``, and
  ``--sampler tempered --device cpu`` through the CLI, unbinned and
  binned.
"""

import json
import os

import functools

import jax
import numpy as np
import pytest
import torch

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu.mcmc import tempered as jt
from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm
from sxmc_tpu_torch.mcmc import tempered as tt

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

NLL_TOL = 1e-3
N_MC = 300  # MC rows per signal of the Pallas-interpret stacks
BETAS = (1.0, 0.5, 0.25)
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")


@pytest.fixture(scope="module")
def pallas_pair():
    from sxmc_tpu.pdf.stack import force_pallas_interpret

    with force_pallas_interpret():
        jmc = jm.MCMC(*make_stack_inputs("sxmc_tpu", n_mc=N_MC))
    assert jmc.stack.supports_fused
    jmc.stack.set_data(make_data())
    tmc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch", n_mc=N_MC),
                  device="cpu")
    tmc.stack.set_data(make_data())
    return jmc, tmc


@functools.lru_cache(maxsize=None)
def _draws(npar):
    """Jitted per-key draws over a 2-D grid of keys: N(0, 1) rows of
    npar, and U[0, 1) scalars (made once: each new lambda retraces)."""
    normal = jax.jit(jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (npar,)))))
    uniform = jax.jit(jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, ()))))
    return normal, uniform


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _interval_keys(k, n, ntemps, npar):
    ks = jax.random.split(k, ntemps)
    return jax.vmap(lambda kk: jax.random.split(kk, 2 * n).reshape(
        n, 2, -1))(ks)


def _interval_xs(k, n, ntemps, npar):
    """tempered.py's interval_xs, returning u (the port takes log(u))."""
    normal, uniform = _draws(npar)
    split = _interval_keys(k, n, ntemps, npar)
    return (np.moveaxis(np.asarray(normal(split[:, :, 0])), 0, 1),
            np.moveaxis(np.asarray(uniform(split[:, :, 1])), 0, 1))


def _fused_streams(k, n, ntemps, npar, swap_every):
    """One phase of _make_tempered_fused_phase's streams, per step."""
    noise = np.empty((n, ntemps, npar), np.float32)
    u = np.empty((n, ntemps), np.float32)
    swap_u = np.ones((n, ntemps), np.float32)  # read at intervals' ends
    nfull = n // swap_every
    if nfull:
        keys = jax.random.split(k, nfull + 1)
        seg_keys = jax.vmap(jax.random.split)(keys[:nfull])
        for i in range(nfull):
            a, b = i * swap_every, (i + 1) * swap_every
            noise[a:b], u[a:b] = _interval_xs(seg_keys[i, 0], swap_every,
                                              ntemps, npar)
            swap_u[b - 1] = np.asarray(jax.random.uniform(seg_keys[i, 1],
                                                          (ntemps,)))
        k = keys[-1]
    if n > nfull * swap_every:
        noise[nfull * swap_every:], u[nfull * swap_every:] = _interval_xs(
            k, n - nfull * swap_every, ntemps, npar)
    return noise, u, swap_u


def _stepper_streams(phase_keys, k, n, npar):
    """One phase of _make_tempered_step's streams (phase_keys layout)."""
    normal, uniform = _draws(npar)
    keys_c, k_swap = phase_keys(k, n)
    swap_u = jax.vmap(lambda kk: jax.random.uniform(
        kk, (keys_c.shape[1],)))(k_swap)
    return (np.asarray(normal(keys_c[:, :, 0])),
            np.asarray(uniform(keys_c[:, :, 1])), np.asarray(swap_u))


@pytest.mark.parametrize("route", ["fused", "stepper"])
def test_tempered_runner_fed_jax_streams(pallas_pair, route):
    """Both routes against JAX _run_tempered; with fixed systematics both
    packages take the stepper, with floating ones (the Pallas-interpret
    stack) the fused route."""
    # The stepper's three phases of 12: one stream compile.
    nsteps, burnin, swap_every = (12, 0, 3) if route == "fused" else (36, 12,
                                                                       3)
    lengths = (burnin, burnin, nsteps - 2 * burnin)
    key = jax.random.PRNGKey(5)
    if route == "fused":
        jmc, tmc = pallas_pair
    else:
        jin, tin = (make_stack_inputs(p, n_mc=N_MC)
                    for p in ("sxmc_tpu", "sxmc_tpu_torch"))
        for s in jin[2] + tin[2]:
            s.fixed = True
        jmc, tmc = jm.MCMC(*jin), tm.MCMC(*tin, device="cpu")
        jmc.stack.set_data(make_data())
        tmc.stack.set_data(make_data())
    assert jm._fused_ok(jmc, jmc.stack._read_bins) == (route == "fused")
    assert tm._fused_ok(tmc) == (route == "fused")
    rb, dd = jmc.stack._read_bins, jmc.stack.device_data
    j_s, j_n, j_a, j_sw = jt._run_tempered(jmc, key, rb, dd, nsteps, burnin,
                                           False, BETAS, swap_every)
    npar, ntemps = jmc.nparameters, len(BETAS)
    phase_keys = jt._make_tempered_step(jmc, rb, dd, False, BETAS,
                                        swap_every)[1]
    streams = [_fused_streams(k, n, ntemps, npar, swap_every)
               if route == "fused" else
               _stepper_streams(phase_keys, k, n, npar)
               for k, n in zip(jax.random.split(key, 3), lengths) if n]
    if not burnin:
        streams = [None, None] + streams
    t_s, (t_hi, t_lo), t_a, t_sw = tt.run_tempered(
        tmc, tmc.stack.read_bins, nsteps, burnin, False, BETAS, swap_every,
        interop.tempered_presampler(streams))
    assert t_s.shape == (lengths[2], npar)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-5,
                               atol=1e-6)
    stayed = (np.diff(t_s.numpy(), axis=0) == 0).all(axis=-1)
    np.testing.assert_array_equal(
        stayed, (np.diff(np.asarray(j_s), axis=0) == 0).all(axis=-1))
    np.testing.assert_allclose(
        t_hi.double().numpy() + t_lo.double().numpy(),
        np.asarray(j_n[0], np.float64) + np.asarray(j_n[1], np.float64),
        rtol=0, atol=NLL_TOL)
    assert float(t_a) == pytest.approx(float(j_a), abs=1e-6)
    assert float(t_sw) == float(j_sw)
    assert float(t_sw) > 0 and stayed.any() and not stayed.all()


def test_ladder_and_small_ladders():
    for n, tmax in ((5, 16.0), (2, 4.0), (1, 8.0)):
        np.testing.assert_array_equal(tt.temperature_ladder(n, tmax),
                                      jt.temperature_ladder(n, tmax))
    np.testing.assert_array_equal(tt.swap_partners(2), [[1, 0], [1, 0]])
    np.testing.assert_array_equal(tt.swap_partners(4),
                                  [[1, 0, 3, 2], [0, 2, 1, 3]])
    sources, signals, systs, obs = make_stack_inputs("sxmc_tpu_torch",
                                                     n_mc=N_MC)
    data = make_data()
    one = tt.TemperedMCMC(sources, signals, systs, obs, ntemps=1,
                          device="cpu")
    ls = one(data, 30, 0.2, generator=torch.Generator().manual_seed(1))
    assert ls.samples.shape == (18, 5) and one.last_swap_rate == 0.0
    # Two near-equal temperatures: both pairings use the one pair, and
    # nearly every exchange is taken.
    two = tt.TemperedMCMC(sources, signals, systs, obs, ntemps=2,
                          tmax=1.05, swap_every=2, device="cpu")
    two(data, 40, 0.1, generator=torch.Generator().manual_seed(2))
    assert two.last_swap_rate > 0.6
    dbg = tt.TemperedMCMC(sources, signals, systs, obs, ntemps=3, tmax=4.0,
                          swap_every=4, device="cpu")
    ls = dbg(data, 20, 0.0, debug_mode=True,
             generator=torch.Generator().manual_seed(3))
    assert dbg.last_accept_rate == 1.0 and ls.samples.shape == (20, 5)


@pytest.mark.parametrize("flags", [[], ["--binned"]])
def test_cli_sampler_tempered(tmp_path, flags):
    from sxmc_tpu_torch.cli import main

    with open(os.path.join(GOLDEN, "config.json")) as f:
        cfg = json.load(f)
    cfg["fit"].update(nexperiments=1, nsteps=64, output_format="npz")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    assert main([str(path), str(out), "--device", "cpu", "--data-root",
                 GOLDEN, "--sampler", "tempered"] + flags) == 0
    recs = [json.loads(line) for line in
            (out / "golden_metrics.jsonl").read_text().splitlines()]
    assert "experiment_failed" not in [r["event"] for r in recs]
    fit = [r for r in recs if r["event"] == "experiment_fit"][0]
    assert fit["sampler"] == "tempered" and 0 < fit["accept_rate"] < 1
    limit = [r for r in recs if r["event"] == "experiment_limit"][0]
    assert np.isfinite(limit["upper"])
