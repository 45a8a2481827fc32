"""Kernel B4's tril form (full-covariance proposals) against the JAX
package's Pallas kernel in interpret mode (split from
test_torch_fullcov.py, whose docstring states the tolerances)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu_torch.mcmc import metropolis as tm

from test_torch_fullcov import N_MC, NLL_TOL, NSTEPS, _tril
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


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


@pytest.mark.parametrize("nch", [1, 3])
def test_plain_segment_tril_matches_pallas(pallas_pair, nch):
    jmc, tmc = pallas_pair
    js = jmc.stack
    npar = jmc.nparameters
    lead = (nch,) if nch > 1 else ()
    rng = np.random.default_rng(41 + nch)
    p0 = np.tile(np.asarray(jmc.parameter_means, np.float32),
                 lead + (1,))
    tril = _tril(jmc, nch).reshape(lead + (npar, npar))
    noise = rng.normal(0, 1, (NSTEPS,) + lead + (npar,)).astype(np.float32)
    log_u = np.log(rng.uniform(0, 1, (NSTEPS,) + lead)).astype(np.float32)
    # Both kernels start from the port's NLL at p0 (B3's plain version).
    nll_of = (tmc.stack.fused_nll_pair_batch if nch > 1
              else tmc.stack.fused_nll_pair)
    thi, tlo = nll_of(torch.as_tensor(p0), tmc.stack.read_bins,
                      tmc.nll_spec)
    jhi, jlo = jnp.asarray(thi.numpy()), jnp.asarray(tlo.numpy())
    j_s, j_n, j_a = js.fused_segment(
        jnp.asarray(p0), (jhi, jlo), jnp.asarray(tril), js._read_bins,
        js.device_data, jnp.asarray(noise), jnp.asarray(log_u), jmc.static)
    nll0 = torch.stack([thi, tlo], dim=-1)
    segment = (tmc.stack.fused_segment_tril_batch if nch > 1
               else tmc.stack.fused_segment_tril)
    t_s, t_n, t_a = segment(torch.as_tensor(p0), nll0, torch.as_tensor(tril),
                            tmc.stack.read_bins, torch.as_tensor(noise),
                            torch.as_tensor(log_u), tmc.nll_spec)
    assert t_s.shape == (NSTEPS,) + lead + (npar,)
    np.testing.assert_array_equal(t_a.numpy(),
                                  np.asarray(j_a).reshape(t_a.shape))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(t_n.double().sum(-1).numpy(),
                               np.asarray(j_n, np.float64).sum(-1), rtol=0,
                               atol=NLL_TOL)
    assert 0 < t_a.sum() < t_a.numel()  # the walk both moved and stayed
    # The zero row pins source c; the rest move off the diagonal too.
    assert (t_s[..., 2] == torch.as_tensor(p0)[..., 2]).all()


def test_plain_tril_proposal_is_sequential():
    """cur + L @ z summed from 0.0 in ascending j, one rounded add per
    term, as the TPU kernel and tests/test_fused_segment.py's reference
    loop do: bit for bit the float32 loop."""
    from sxmc_tpu_torch.ops.kernels import tril_propose_plain

    rng = np.random.default_rng(3)
    npar = 6
    tril = np.tril(rng.normal(0, 1, (2, npar, npar))).astype(np.float32)
    z = rng.normal(0, 1, (2, npar)).astype(np.float32)
    cur = rng.normal(0, 1, (2, npar)).astype(np.float32)
    got = tril_propose_plain(torch.as_tensor(cur), torch.as_tensor(tril),
                             torch.as_tensor(z)).numpy()
    want = cur.copy()
    for c in range(2):
        for k in range(npar):
            a = np.float32(0.0)
            for j in range(k + 1):
                a = np.float32(a + np.float32(tril[c, k, j] * z[c, j]))
            want[c, k] = np.float32(cur[c, k] + a)
    np.testing.assert_array_equal(got, want)
