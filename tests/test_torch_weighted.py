"""Weighted MC samples: B1's weighted form (with one segment, B1a's),
B3's and B4's weighted forms and the weighted fit paths against the JAX
package on identical inputs.

Tolerances, each with its reason:
* Bins and norms within 2^-20 relative: the port sums the weights in
  float64 and rounds once (its kernels and their plain versions alike),
  the JAX CPU path accumulates float32 one-hot products.
* NLLs: the port's fused NLL (B3's weighted plain version) and its own
  split path share bit-equal float32 norms, so they agree to float64
  reordering of the event sum; against the JAX package within NLL_TOL
  = 1e-3 (the weighted norms differ by an ulp, and XLA's CPU log from
  torch's), the bar the JAX package sets itself (pallas_step.py:45-51).
* Walks fed the JAX streams: the same accept decisions; against the
  JAX CPU stepper (accept ``u <= exp(delta)``) the port's fused route
  (``log(u) <= delta``) decides alike except within rounding of that
  boundary, NLLs within FUSED_NLL_TOL = 0.05 (an ulp of a proposal can
  move an MC sample across a bin edge under the scale systematic, as in
  test_torch_fullcov.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu.ops.nll import nll_pair as j_nll_pair
from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm
from sxmc_tpu_torch.ops.nll import nll_pair as t_nll_pair

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

REL = 2.0 ** -20
NLL_TOL = 1e-3
FUSED_NLL_TOL = 0.05
N_MC = 400


def _weighted_inputs(pkg, dyn_w=True, stat_w=True, n_mc=N_MC):
    """make_stack_inputs with log-normal (sigma 0.3) weights on signal
    "a" (dynamic) and / or "c" (static), as _weighted_fixture's cases
    in test_fused_step.py; "b" stays unweighted."""
    srcs, sigs, systs, obs = make_stack_inputs(pkg, n_mc=n_mc)
    rng = np.random.default_rng(77)
    w = rng.lognormal(0.0, 0.3, (3, n_mc)).astype(np.float32)
    if dyn_w:
        sigs[0].histogram.weights = w[0]
    if stat_w:
        sigs[2].histogram.weights = w[2]
    return srcs, sigs, systs, obs


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_evalhist_weighted_matches_jax(weighted):
    """B1a (EvalHist.histogram: B1 with one segment), the density export
    and random_sample on a 2-D PDF with a shift systematic."""
    from sxmc_tpu.pdf.evalhist import EvalHist as JaxHist
    from sxmc_tpu.ops.transforms import SHIFT as JSHIFT, \
        SystematicDesc as JDesc
    from sxmc_tpu_torch.ops.transforms import SHIFT, SystematicDesc
    from sxmc_tpu_torch.pdf.evalhist import EvalHist, PdfError

    rng = np.random.default_rng(4)
    samples = np.stack([rng.normal(5, 2, 3000), rng.uniform(0, 3, 3000)],
                       axis=1).astype(np.float32)
    w = (rng.lognormal(0, 0.3, 3000).astype(np.float32) if weighted
         else None)
    args = (samples, 2, 2, [0.0, 0.0], [10.0, 3.0], [8, 3])
    j = JaxHist(*args, dataset=1, weights=w)
    j.add_systematic(JDesc(type=JSHIFT, obs=0, par_indices=(0,)))
    t = EvalHist(*args, dataset=1, weights=w, device="cpu")
    t.add_systematic(SystematicDesc(type=SHIFT, obs=0, par_indices=(0,)))
    assert t.hist_spec().weighted == weighted
    for theta in ([0.0], [0.37]):
        jb, jn = j.histogram(theta)
        tb, tn = t.histogram(theta)
        _close(tb.numpy(), jb)
        _close(tn.numpy(), jn)
        _close(t.density_histogram(theta), j.density_histogram(theta))
        for axis in (0, 1):
            _close(t.density_projection(axis, theta),
                   j.density_projection(axis, theta))
    ev = t.random_sample(torch.Generator().manual_seed(2), 500.0,
                         syst_vals=[0.37], uppers=[8.0, 3.0],
                         lowers=[1.0, 0.0])
    assert ev.shape == (500, 3) and (ev[:, 2] == 1.0).all()
    # Bins wholly outside the bounds are excluded (bin 7, [8.75, 10)).
    assert (ev[:, 0] >= 0.0).all() and (ev[:, 0] < 8.75).all()
    dens = t.density_histogram([0.37])
    ix = np.floor(ev[:, 0] / 1.25).astype(int)
    iy = np.floor(ev[:, 1]).astype(int)
    assert (dens[ix, iy] > 0).all()  # drawn only where the PDF is
    with pytest.raises(PdfError):
        t.density_projection(2)


@pytest.mark.parametrize("dyn_w,stat_w", [(True, False), (False, True),
                                          (True, True)])
def test_weighted_stack_matches_jax(dyn_w, stat_w):
    """Histograms, norms and the LUT of a weighted PdfStack, and the NLL
    through the fused kernel's plain version against the split path."""
    jsrc, jsig, jsys, jobs = _weighted_inputs("sxmc_tpu", dyn_w, stat_w)
    tsrc, tsig, tsys, tobs = _weighted_inputs("sxmc_tpu_torch", dyn_w,
                                              stat_w)
    for a, b in zip(jsig, tsig):
        w = interop.weights(a.histogram)
        assert (w is None) == (b.histogram.weights is None)
        if w is not None:
            np.testing.assert_array_equal(b.histogram.weights, w)
    jmc = jm.MCMC(jsrc, jsig, jsys, jobs)
    tmc = tm.MCMC(tsrc, tsig, tsys, tobs, device="cpu")
    assert tmc.stack.has_weights and tmc.stack.hist_spec.weighted == dyn_w
    data = make_data()
    jmc.stack.set_data(data)
    tmc.stack.set_data(data)
    params = np.asarray([1.02, 0.95, 1.01, 0.013, -0.004], np.float32)
    theta = params[3:]
    jh, jn = jmc.stack.histograms(theta)
    th, tn = tmc.stack.histograms(theta)
    _close(th.numpy(), jh)
    _close(tn.numpy(), jn)
    jlut, jnorm = jmc.stack.evaluate(theta)
    tlut, tnorm = tmc.stack.evaluate(theta)
    np.testing.assert_allclose(tlut.numpy(), np.asarray(jlut), rtol=4 * REL,
                               atol=0)
    split = [float(x) for x in t_nll_pair(torch.as_tensor(params), tlut,
                                          tnorm, tmc.nll_spec.consts)]
    fused = [float(x) for x in tmc.stack.fused_nll_pair(
        torch.as_tensor(params), tmc.stack.read_bins, tmc.nll_spec)]
    assert abs(sum(fused) - sum(split)) < 1e-6 * abs(sum(split))
    jhi, jlo = j_nll_pair(jnp.asarray(params), jlut, jnorm, jmc.static)
    assert abs(sum(fused) - (float(jhi) + float(jlo))) < NLL_TOL


