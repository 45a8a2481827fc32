"""sxmc_tpu_torch.mcmc.stretch against the JAX package.

The JAX package's two walker ensembles (from fixed keys, at the inputs
of ``test_torch_pdf.make_stack_inputs`` / ``make_data``) and the draws
it derived from its keys (the initial cloud's normals; per half-move the
z uniforms, the partner indices and the accept uniforms) are stored by
``tests/data/sampler_reference/make_reference.py``.  Fed those draws,
the port's ensembles (one, and both as one batch) must match the JAX
walkers over their first steps: positions within 1e-5 relative, NLLs
within 1e-3 absolute (the batched NLL's float64 sums against the JAX
package's compensated float32 pairs); over the whole run the moments
agree, and a run on the port's generator agrees statistically with a
JAX run of the same length.  Last, the likelihood space's correlations
when one parameter alone moves (a case the samplers' short runs reach).
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc.stretch import StretchSampler

from test_torch_hmc import GEN, REF, agree_statistically
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

FIRST = 10


def port(fixed_b: bool = False, binned: bool = False):
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch",
                                               n_mc=GEN.N_MC)
    if fixed_b:
        srcs[1].fixed = True
    return StretchSampler(srcs, sigs, systs, obs, device="cpu",
                          binned=binned)


def fed(chains, binned: bool = False):
    s = port(binned=binned)
    draws = interop.chains_draws([[REF[f"stretch_draws_{i}_c{c}"]
                                   for i in range(3)] for c in chains])
    # chains_draws puts the chain axis second; the stretch layout takes it
    # after the half-move axis: (n, 2, nchains, half).
    if len(chains) > 1:
        draws = tuple(np.moveaxis(x, 1, 2) for x in draws)
    init = interop.chains_draws([[REF[f"stretch_init_c{c}"]]
                                 for c in chains])[0]
    if len(chains) > 1:
        init = np.moveaxis(init, 1, 0)
    ls = s(make_data(nev=GEN.NEV), GEN.STRETCH_STEPS, 0.0,
           nchains=len(chains), presampler=interop.stretch_presampler(*draws),
           init_noise=torch.as_tensor(np.ascontiguousarray(init)))
    k = s.nwalkers
    hist = ls.samples.reshape(len(chains), GEN.STRETCH_STEPS, k, -1)
    nll = ls.nll_values.reshape(len(chains), GEN.STRETCH_STEPS, k)
    return s, hist, nll


@pytest.mark.parametrize("nch", [1, 2])
def test_ensembles_fed_jax_draws_match_jax(nch):
    s, hist, nll = fed(range(nch))
    assert s.nwalkers == 16   # max(2 * 5 + 2, 16)
    for c in range(nch):
        want = REF[f"stretch_hist_c{c}"]
        np.testing.assert_allclose(hist[c, :FIRST], want[:FIRST],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(nll[c, :FIRST],
                                   REF[f"stretch_nll_c{c}"][:FIRST],
                                   atol=1e-3)
        np.testing.assert_allclose(hist[c].reshape(-1, 5).mean(0),
                                   want.reshape(-1, 5).mean(0),
                                   atol=0.3 * want.reshape(-1, 5).std(0).max())
    acc = np.mean([float(REF[f"stretch_accept_c{c}"]) for c in range(nch)])
    assert abs(s.last_accept_rate - acc) < 0.05


def test_binned_ensemble_walks_as_unbinned():
    """The binned NLL regroups the unbinned one exactly: fed the same
    draws, the binned ensemble walks the same path over its first
    steps."""
    _, hist, nll = fed(range(1))
    _, hist_b, nll_b = fed(range(1), binned=True)
    np.testing.assert_allclose(hist_b[:, :FIRST], hist[:, :FIRST],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(nll_b[:, :FIRST], nll[:, :FIRST], atol=1e-3)


def test_own_generator_agrees_statistically():
    """Ensembles on the port's generator against the JAX run of the same
    steps, burn-in and ensemble count (``stretch_stat_samples``)."""
    s = port()
    ls = s(make_data(nev=GEN.NEV), GEN.STRETCH_STAT_STEPS, GEN.STAT_BF,
           nchains=GEN.STAT_CHAINS, generator=torch.Generator().manual_seed(3))
    want = REF["stretch_stat_samples"]
    assert ls.samples.shape == want.shape
    agree_statistically(ls.samples, want, GEN.STAT_CHAINS, ncols=5)


def test_debug_mode_accepts_everything():
    s = port()
    ls = s(make_data(nev=GEN.NEV), 6, 0.0, debug_mode=True,
           generator=torch.Generator().manual_seed(4))
    assert s.last_accept_rate == 1.0
    hist = ls.samples.reshape(6, 16, 5)
    assert (np.diff(hist[:, :, 0], axis=0) != 0).all()


def test_fixed_parameter_pinned():
    s = port(fixed_b=True)
    ls = s(make_data(nev=GEN.NEV), 10, 0.2,
           generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(ls.column("b"), np.float32(1.0))
    assert (ls.column("a") > 0).all()


def test_correlations_when_one_parameter_moves():
    """A chain in which one parameter alone moves (a short gradient run
    that accepted little) still prints its correlations: the JAX
    package's ``correlation_matrix`` indexes numpy's 0-d ``corrcoef`` of
    one row and raises; the port's gives that parameter's 1."""
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    samples = np.zeros((6, 3), np.float32)
    samples[:, 1] = np.arange(6)
    ls = LikelihoodSpace.from_arrays(samples, np.arange(6.0),
                                     ["a", "b", "c"])
    mat, _ = ls.correlation_matrix()
    np.testing.assert_array_equal(mat, np.eye(3))
    assert "b" in ls.print_correlations()
