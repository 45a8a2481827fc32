"""sxmc_tpu_torch.mcmc.metropolis against sxmc_tpu.mcmc.metropolis.

Both packages run on identical inputs: the same MC tables and dataset,
and, for the walk, the JAX package's own ``_presample`` noise streams
handed to the port through ``sxmc_tpu_torch.interop``.  The JAX side
runs its CPU path (the scan stepper, accept ``u <= exp(delta)``); the
port runs the fused kernels' plain versions (accept ``log(u) <=
delta``) where systematics float, which decide alike except within
rounding of u == exp(delta), and the same scan stepper where they are
fixed.
NLL tolerance 1e-3 absolute as in test_torch_ops.py.
"""

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
# share the cores do not oversubscribe them (with one thread per core
# in every worker these tests ran ten times slower under xdist).
torch.set_num_threads(1)

NLL_TOL = 1e-3

# The JAX noise streams, drawn under jit as the JAX runner draws them
# (op by op every new shape compiles anew).
_presample = jax.jit(jm._presample, static_argnums=(1, 2))


@pytest.fixture(scope="module")
def chains():
    jsrcs, jsigs, jsysts, jobs = make_stack_inputs("sxmc_tpu")
    jmc = jm.MCMC(jsrcs, jsigs, jsysts, jobs)
    jmc.stack.set_data(make_data())
    tsrcs, tsigs, tsysts, tobs = make_stack_inputs("sxmc_tpu_torch")
    tmc = tm.MCMC(tsrcs, tsigs, tsysts, tobs, device="cpu")
    tmc.stack.set_data(make_data())
    return jmc, tmc


def test_parameters_and_widths_match(chains):
    jmc, tmc = chains
    assert tmc.parameter_names == jmc.parameter_names
    np.testing.assert_array_equal(tmc.parameter_means, jmc.parameter_means)
    np.testing.assert_array_equal(tmc.parameter_fixed, jmc.parameter_fixed)
    np.testing.assert_array_equal(tmc.initial_jump_widths(),
                                  jmc.initial_jump_widths())
    st = interop.nll_static(jmc.static)
    for a, b in zip(st, tmc.static):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_initial_state_matches(chains):
    jmc, tmc = chains
    jp, (jhi, jlo), jw = jm.initial_state(jmc, jmc.stack._read_bins,
                                          jmc.stack.device_data)
    tp, (thi, tlo), tw = tm.initial_state(tmc, tmc.stack.read_bins)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert abs(float(thi.double() + tlo.double())
               - float(np.float64(jhi) + np.float64(jlo))) <= NLL_TOL


def test_retune_width_matches(chains):
    jmc, tmc = chains
    rng = np.random.default_rng(2)
    phase = rng.normal(1.0, 0.05, (300, tmc.nparameters)).astype(np.float32)
    phase[:, 2] = 1.0  # a parameter that never moved keeps its width
    width = tmc.initial_jump_widths()
    want = np.asarray(jm.retune_width(jmc, jnp.asarray(width),
                                      jnp.asarray(phase)))
    got = tm.retune_width(tmc, torch.as_tensor(width),
                          torch.as_tensor(phase)).numpy()
    # The port takes the RMS in f64, the JAX package in f32.
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[2] == width[2]


@pytest.mark.parametrize("nsteps,seed", [(20, 5), (16, 8)])
def test_run_segment_fed_jax_streams(chains, nsteps, seed):
    jmc, tmc = chains
    rb, dd = jmc.stack._read_bins, jmc.stack.device_data
    p0, nll0, w0 = jm.initial_state(jmc, rb, dd)
    key = jax.random.PRNGKey(seed)
    jp, jn, js, jnl, jacc = jm.run_segment(jmc, p0, nll0, w0, rb, dd, key,
                                           nsteps)
    noise, u = _presample(jax.random.split(key, nsteps), jmc.nparameters,
                          0)
    t_noise, t_u = interop.stream(noise, u)
    tp, tnll, tw = interop.chain_state(p0, nll0, w0)
    _, _, ts, (thi, tlo), tacc = tm.run_segment(
        tmc, tp, tnll, tw, tmc.stack.read_bins, t_noise, t_u)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    want = np.asarray(jnl[0], np.float64) + np.asarray(jnl[1], np.float64)
    got = thi.double().numpy() + tlo.double().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NLL_TOL)
    assert float(tacc.mean()) == pytest.approx(float(jacc), abs=1e-6)


def test_presample_shapes_and_determinism():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    n1, u1 = tm.presample(g1, 50, 4, "cpu")
    n2, u2 = tm.presample(g2, 50, 4, "cpu")
    assert n1.shape == (50, 4) and u1.shape == (50,)
    assert n1.dtype == u1.dtype == torch.float32
    assert torch.equal(n1, n2) and torch.equal(u1, u2)
    assert bool(((u1 >= 0) & (u1 < 1)).all())
    nb, ub = tm.presample(g1, 50, 4, "cpu", nchains=3)
    assert nb.shape == (50, 3, 4) and ub.shape == (50, 3)


@pytest.mark.parametrize("kw", [dict(nchains=2), dict(rate_substeps=1),
                                dict(proposal="full_cov")])
def test_out_of_slice_options_raise(chains, kw):
    """Options once off the port, each ported since, now run: nchains > 1
    pools two lock-step chains chain-major, rate_substeps takes blocked
    cycles (nsteps counts cycles), full_cov Haario proposals."""
    _, tmc = chains
    nch = kw.get("nchains", 1)
    ls = tmc(make_data(), 100, 0.2, generator=torch.Generator(), **kw)
    assert ls.samples.shape == (nch * 60, tmc.nparameters)
    assert np.isfinite(ls.samples).all()
    assert np.isfinite(ls.nll_values).all()
    assert 0.0 < tmc.last_accept_rate < 1.0


def test_fixed_systematics_raise():
    """Fixed systematics (the split path, once raising) build their LUT
    once with B1 + B2 and step with the scan path's stepper: the same
    walk as the JAX package fed the same streams."""
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch")
    jsrcs, jsigs, jsysts, jobs = make_stack_inputs("sxmc_tpu")
    for s in systs + jsysts:
        s.fixed = True
    tmc = tm.MCMC(srcs, sigs, systs, obs, device="cpu")
    jmc = jm.MCMC(jsrcs, jsigs, jsysts, jobs)
    for m in (tmc, jmc):
        m.stack.set_data(make_data())
    rb, dd = jmc.stack._read_bins, jmc.stack.device_data
    p0, nll0, w0 = jm.initial_state(jmc, rb, dd)
    key = jax.random.PRNGKey(4)
    _, _, js, jnl, jacc = jm.run_segment(jmc, p0, nll0, w0, rb, dd, key,
                                         24)
    noise, u = _presample(jax.random.split(key, 24), jmc.nparameters, 0)
    tp, tnll, tw = tm.initial_state(tmc, tmc.stack.read_bins)
    assert abs(float(tnll[0].double() + tnll[1].double())
               - float(np.float64(nll0[0]) + np.float64(nll0[1]))) <= NLL_TOL
    t_noise, t_u = interop.stream(noise, u)
    _, _, ts, (thi, tlo), tacc = tm.run_segment(
        tmc, *interop.chain_state(p0, nll0, w0), tmc.stack.read_bins,
        t_noise, t_u)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    want = np.asarray(jnl[0], np.float64) + np.asarray(jnl[1], np.float64)
    np.testing.assert_allclose(thi.double().numpy() + tlo.double().numpy(),
                               want, rtol=0, atol=NLL_TOL)
    assert float(tacc.mean()) == pytest.approx(float(jacc), abs=1e-6)
    assert np.all(np.asarray(js)[:, 3:] == 0.0)  # the fixed ones stay
