"""Kernel B5's plain version against the JAX package's Pallas kernel
``fused_segment_blocked`` in interpret mode (split from
test_torch_blocked.py, whose docstring states the tolerances)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu_torch.mcmc import metropolis as tm

from test_torch_blocked import M, N_MC, NCYCLES, NLL_TOL
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pallas_pair():
    from sxmc_tpu.pdf.stack import force_pallas_interpret

    with force_pallas_interpret():
        jmc = jm.MCMC(*make_stack_inputs("sxmc_tpu", n_mc=N_MC))
    assert jmc.stack.supports_fused and not jmc.stack.has_weights
    jmc.stack.set_data(make_data())
    tmc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch", n_mc=N_MC),
                  device="cpu")
    tmc.stack.set_data(make_data())
    return jmc, tmc


@pytest.mark.parametrize("nch", [1, 3])
def test_plain_blocked_segment_matches_pallas(pallas_pair, nch):
    jmc, tmc = pallas_pair
    js = jmc.stack
    npar = jmc.nparameters
    lead = (nch,) if nch > 1 else ()
    rng = np.random.default_rng(61 + nch)
    p0 = np.tile(np.asarray(jmc.parameter_means, np.float32), lead + (1,))
    w0 = np.tile(np.asarray(jmc.initial_jump_widths(), np.float32),
                 lead + (1,))
    w0[..., 2] = -1.0  # pinned: neither block moves it
    if nch > 1:
        w0[1] *= 2.0  # chains walk with their own widths
    noise = rng.normal(0, 1, (NCYCLES, M + 1) + lead + (npar,)).astype(
        np.float32)
    log_u = np.log(rng.uniform(0, 1, (NCYCLES, M + 1) + lead)).astype(
        np.float32)
    # Both kernels start from the port's NLL at p0 (B3's plain version).
    nll_of = (tmc.stack.fused_nll_pair_batch if nch > 1
              else tmc.stack.fused_nll_pair)
    thi, tlo = nll_of(torch.as_tensor(p0), tmc.stack.read_bins,
                      tmc.nll_spec)
    jhi, jlo = jnp.asarray(thi.numpy()), jnp.asarray(tlo.numpy())
    j_s, j_n, j_a = js.fused_segment_blocked(
        jnp.asarray(p0), (jhi, jlo), jnp.asarray(w0), js._read_bins,
        js.device_data, jnp.asarray(noise), jnp.asarray(log_u), jmc.static,
        M)
    nll0 = torch.stack([thi, tlo], dim=-1)
    segment = (tmc.stack.blocked_segment_batch if nch > 1
               else tmc.stack.blocked_segment)
    t_s, t_n, t_a = segment(torch.as_tensor(p0), nll0, torch.as_tensor(w0),
                            tmc.stack.read_bins, torch.as_tensor(noise),
                            torch.as_tensor(log_u), tmc.nll_spec)
    assert t_s.shape == (NCYCLES,) + lead + (npar,)
    assert t_a.shape == (NCYCLES,) + lead
    np.testing.assert_array_equal(t_a.numpy(),
                                  np.asarray(j_a).reshape(t_a.shape))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(t_n.double().sum(-1).numpy(),
                               np.asarray(j_n, np.float64).sum(-1), rtol=0,
                               atol=NLL_TOL)
    # Fractions of M + 1 decisions, some taken and some not.
    assert set(np.unique(t_a.numpy() * (M + 1)).tolist()) <= {0, 1, 2, 3}
    assert 0 < t_a.sum() < t_a.numel()
    assert (t_s[..., 2] == torch.as_tensor(p0)[..., 2]).all()


def test_plain_blocked_debug_accepts_all(pallas_pair):
    """Debug mode takes every move: after a cycle the systematics have
    moved by the row-0 noise, the rates by the rows 1..M noise."""
    _, tmc = pallas_pair
    st = tmc.stack
    params, nll0, width = tm.initial_state(tmc, st.read_bins)
    rng = np.random.default_rng(4)
    noise = torch.as_tensor(rng.normal(0, 1, (3, M + 1, tmc.nparameters)
                                       ).astype(np.float32))
    log_u = torch.full((3, M + 1), -50.0)
    s, _, a = st.blocked_segment(params, torch.stack(nll0), width,
                                 st.read_bins, noise, log_u, tmc.nll_spec,
                                 debug_mode=True)
    assert bool((a == 1).all())
    rate = torch.arange(tmc.nparameters) < tmc.nsources
    step = torch.where(rate, noise[:, 1:].sum(1), noise[:, 0]) * width
    torch.testing.assert_close(s, params + torch.cumsum(step, 0), rtol=1e-5,
                               atol=1e-6)
