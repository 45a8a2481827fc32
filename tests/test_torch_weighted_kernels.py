"""The weighted forms of the kernels' plain versions against the JAX
package's Pallas kernels in interpret mode, and weighted segments fed
the JAX streams (split from test_torch_weighted.py, whose docstring
states the tolerances)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm

from test_torch_fullcov import _presample, same_walk
from test_torch_pdf import make_data
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)
from test_torch_weighted import FUSED_NLL_TOL, NLL_TOL, _weighted_inputs

torch.set_num_threads(1)


def test_plain_weighted_kernels_match_pallas():
    """B3's weighted form and B4's weighted tempered form (three
    lock-step replicas at beta 1, 0.3 and 0.05; dynamic and static rows
    weighted) against the JAX Pallas kernels in interpret mode, fed the
    same noise.  This is the kernel-level check of B4's tempered form
    too (test_torch_tempered.py holds it through the runners); replica 0,
    at beta = 1, anchors B4's untempered weighted form, which must walk
    exactly as that replica."""
    from sxmc_tpu.pdf.stack import force_pallas_interpret

    with force_pallas_interpret():
        jmc = jm.MCMC(*_weighted_inputs("sxmc_tpu"))
    js = jmc.stack
    assert js.supports_fused and js.has_weights
    js.set_data(make_data())
    tmc = tm.MCMC(*_weighted_inputs("sxmc_tpu_torch"), device="cpu")
    tmc.stack.set_data(make_data())
    beta = np.asarray([1.0, 0.3, 0.05], np.float32)
    nch, nsteps, npar = len(beta), 8, jmc.nparameters
    rng = np.random.default_rng(12)
    p0 = (np.asarray(jmc.parameter_means, np.float32)
          + rng.normal(0, 0.01, (nch, npar)).astype(np.float32))
    width = (np.tile(np.maximum(jmc.initial_jump_widths(), 0) * 3,
                     (nch, 1)) / np.sqrt(beta)[:, None]).astype(np.float32)
    noise = rng.normal(0, 1, (nsteps, nch, npar)).astype(np.float32)
    log_u = np.log(rng.uniform(0, 1, (nsteps, nch))).astype(np.float32)
    jhi, jlo = js.fused_nll_pair(jnp.asarray(p0), js._read_bins,
                                 js.device_data, jmc.static)
    thi, tlo = tmc.stack.fused_nll_pair_batch(
        torch.as_tensor(p0), tmc.stack.read_bins, tmc.nll_spec)
    np.testing.assert_allclose(
        thi.double().numpy() + tlo.double().numpy(),
        np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64), rtol=0,
        atol=NLL_TOL)
    params, (hi, lo), w, _ = interop.ladder_state(
        p0, (thi.numpy(), tlo.numpy()), width, 0)
    nll0 = torch.stack([hi, lo], dim=-1)
    j_s, j_n, j_a = js.fused_segment(
        jnp.asarray(p0), (jnp.asarray(thi.numpy()), jnp.asarray(tlo.numpy())),
        jnp.asarray(width), js._read_bins, js.device_data,
        jnp.asarray(noise), jnp.asarray(log_u), jmc.static,
        beta=jnp.asarray(beta))
    t_s, t_n, t_a = tmc.stack.fused_segment_tempered(
        params, nll0, w, torch.as_tensor(beta), tmc.stack.read_bins,
        torch.as_tensor(noise), torch.as_tensor(log_u), tmc.nll_spec)
    np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(t_n.double().sum(-1).numpy(),
                               np.asarray(j_n, np.float64).sum(-1), rtol=0,
                               atol=NLL_TOL)
    assert 0 < t_a.sum() < t_a.numel()
    u_s, u_n, u_a = tmc.stack.fused_segment_batch(
        params, nll0, w, tmc.stack.read_bins, torch.as_tensor(noise),
        torch.as_tensor(log_u), tmc.nll_spec)
    assert torch.equal(u_s[:, 0], t_s[:, 0])
    assert torch.equal(u_n[:, 0], t_n[:, 0])
    assert not torch.equal(u_a, t_a)  # the annealing decides otherwise


@pytest.mark.parametrize("m", [0, 2])
def test_weighted_segment_fed_jax_streams(m):
    """A weighted chain's segment, fed the JAX streams.  Joint steps (m =
    0) take the fused route, B4's weighted form; blocked cycles (m = 2)
    the blocked stepper, as B5 takes unweighted stacks only
    (metropolis.py:422-426), on both sides step for step."""
    nsteps = 12
    jmc = jm.MCMC(*_weighted_inputs("sxmc_tpu"))
    tmc = tm.MCMC(*_weighted_inputs("sxmc_tpu_torch"), device="cpu")
    assert tm._fused_ok(tmc) and not tm._blocked_fused_ok(tmc)
    assert tm._blocked_enabled(tmc, 2)
    data = make_data()
    jmc.stack.set_data(data)
    tmc.stack.set_data(data)
    rb, dd = jmc.stack._read_bins, jmc.stack.device_data
    p0, nll0, w0 = jm.initial_state(jmc, rb, dd)
    key = jax.random.PRNGKey(37 + m)
    _, _, js, jnl, jacc = jm.run_segment(jmc, p0, nll0, w0, rb, dd, key,
                                         nsteps, rate_substeps=m)
    noise, u = interop.stream(*_presample(jax.random.split(key, nsteps),
                                          jmc.nparameters, m))
    _, _, ts, (thi, tlo), tacc = tm.run_segment(
        tmc, *interop.chain_state(p0, nll0, w0), tmc.stack.read_bins, noise,
        u, rate_substeps=m)
    if m:  # the same stepper: step for step
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-7)
    else:
        same_walk(ts.numpy(), np.asarray(js), 1)
    np.testing.assert_allclose(
        thi.double().numpy() + tlo.double().numpy(),
        np.asarray(jnl[0], np.float64) + np.asarray(jnl[1], np.float64),
        rtol=0, atol=NLL_TOL if m else FUSED_NLL_TOL)
    assert float(tacc.mean()) == pytest.approx(float(jacc), abs=1e-6)
