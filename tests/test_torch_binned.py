"""The binned likelihood against the JAX package on identical inputs.

``binned_nll_pair`` (single and batched over chains) and the data-count
helpers against ``sxmc_tpu.ops.nll.binned_nll_pair`` and the JAX
PdfStack's; then ``MCMC(binned=True)`` end to end, one chain and three
lock-step chains, fed the JAX package's own noise streams through
``interop``.  Both packages take the scan stepper here (accept ``u <=
exp(delta)``), so decisions are identical; parameters are held within
1e-6 relative (XLA may contract a proposal into an FMA) and NLLs within
1e-3 absolute (NLL_TOL, as test_torch_ops.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu.ops import nll as j_nll
from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm
from sxmc_tpu_torch.ops import nll as t_nll

from test_torch_chains import _phase_xs
from test_torch_fullcov import _presample
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them.
torch.set_num_threads(1)

NLL_TOL = 1e-3


@pytest.fixture(scope="module")
def fits():
    jmc = jm.MCMC(*make_stack_inputs("sxmc_tpu"), binned=True)
    tmc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch"), device="cpu",
                  binned=True)
    return jmc, tmc


def test_data_counts_match_jax(fits):
    jmc, tmc = fits
    data = make_data()
    assert tmc.stack.unique_datasets == jmc.stack.unique_datasets
    np.testing.assert_array_equal(tmc.stack.dataset_mask,
                                  jmc.stack.dataset_mask)
    want = np.asarray(jmc.stack.data_bin_counts(data))
    np.testing.assert_array_equal(tmc.stack.data_bin_counts(data).numpy(),
                                  want)
    rb = tmc.stack.compute_read_bins(data)
    np.testing.assert_array_equal(
        tmc.stack.counts_from_read_bins(rb).numpy(), want)


@pytest.mark.parametrize("batched", [False, True])
def test_binned_nll_pair_matches_jax(fits, batched):
    jmc, tmc = fits
    data = make_data()
    counts = np.array(jmc.stack.data_bin_counts(data))
    mask = jmc.stack.dataset_mask
    bv = jmc.stack.bin_volume
    params = np.asarray([[1.0, 1.0, 1.0, 0.0, 0.0],
                         [1.2, 0.85, 1.05, 0.011, -0.006],
                         [-0.1, 1.0, 1.0, 0.0, 0.0]], np.float32)
    thetas = params[:, 3:]
    th, tn = tmc.stack.histograms_batch(torch.as_tensor(thetas))
    args = (torch.as_tensor(counts), torch.as_tensor(mask), bv)
    if batched:
        hi, lo = t_nll.binned_nll_pair(torch.as_tensor(params), th, tn,
                                       tmc.nll_spec.consts, *args)
    for c in range(3):
        jh, jn = jmc.stack.histograms(jnp.asarray(thetas[c]))
        whi, wlo = j_nll.binned_nll_pair(jnp.asarray(params[c]), jh, jn,
                                         jmc.static, jnp.asarray(counts),
                                         jnp.asarray(mask), bv)
        want = float(np.float64(whi) + np.float64(wlo))
        if batched:
            got = float(hi[c].double() + lo[c].double())
        else:
            h1, l1 = t_nll.binned_nll_pair(torch.as_tensor(params[c]), th[c],
                                           tn[c], tmc.nll_spec.consts, *args)
            got = float(h1.double() + l1.double())
        assert abs(got - want) <= NLL_TOL, (c, got, want)
    if batched:
        assert float(hi[2]) == float(np.float32(1e18))


def _check_space(tls, jls):
    np.testing.assert_allclose(tls.samples, jls.samples, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tls.nll_values, jls.nll_values, rtol=0,
                               atol=NLL_TOL)


def test_mcmc_binned_one_chain_fed_jax_streams(fits):
    jmc, tmc = fits
    nsteps, frac = 42, 0.34  # three phases of 14: one stream compile
    burnin = int(nsteps * frac)
    key = jax.random.PRNGKey(12)
    jls = jmc(make_data(), nsteps, frac, key=key)
    chain_key = jax.random.split(key, 1)[0]
    lengths = (burnin, burnin, nsteps - 2 * burnin)
    streams = []
    for k, n in zip(jax.random.split(chain_key, 3), lengths):
        noise, u = _presample(jax.random.split(k, n), jmc.nparameters, 0)
        streams.append((np.asarray(noise), np.asarray(u)))
    tls = tmc(make_data(), nsteps, frac,
              presampler=interop.presampler(streams))
    _check_space(tls, jls)
    assert tmc.last_accept_rate == pytest.approx(jmc.last_accept_rate,
                                                 abs=1e-6)


def test_mcmc_binned_chains_fed_jax_streams(fits):
    jmc, tmc = fits
    nsteps, frac, nch = 30, 0.34, 3  # three phases of 10
    burnin = int(nsteps * frac)
    key = jax.random.PRNGKey(13)
    jls = jmc(make_data(), nsteps, frac, key=key, nchains=nch)
    keys3 = jax.vmap(lambda k: jax.random.split(k, 3))(
        jax.random.split(key, nch))
    lengths = (burnin, burnin, nsteps - 2 * burnin)
    streams = [_phase_xs(keys3[:, p], n, jmc.nparameters)
               for p, n in enumerate(lengths)]
    tls = tmc(make_data(), nsteps, frac, nchains=nch,
              presampler=interop.presampler(streams))
    assert tls.samples.shape == (nch * lengths[2], tmc.nparameters)
    _check_space(tls, jls)
