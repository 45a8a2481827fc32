"""sxmc_tpu_torch.pdf.stack with KDE rows against sxmc_tpu.pdf.stack.

The KDE inputs of ``test_torch_kde.make_kde_inputs`` (a KDE signal and a
histogram, a floating shift on both) through both packages' PdfStack:
the layout (the KDE's empty segment among the dynamic ones), the
histograms with their KDE grid rows, and ``evaluate`` /
``evaluate_batch`` with the grid and with ``use_exact_kde``.  Histogram
rows are integer counts and equal; KDE rows at test_torch_kde's rtol
2e-5 (argued there).
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.mcmc import metropolis as tm
from sxmc_tpu_torch.ops import kernels
from sxmc_tpu_torch.pdf.stack import PdfStack

from test_torch_kde import RTOL, make_kde_data, make_kde_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

THETAS = (0.0, 0.3)


def _stacks(exact: bool, syst: bool = True):
    from sxmc_tpu.pdf.stack import PdfStack as JStack

    data = make_kde_data()
    jsrcs, jsigs, jsysts, jobs = make_kde_inputs("sxmc_tpu", exact, syst)
    tsrcs, tsigs, tsysts, tobs = make_kde_inputs("sxmc_tpu_torch", exact,
                                                 syst)
    js = JStack(jsigs, jobs, jsysts)
    ts = PdfStack(tsigs, tobs, tsysts, device="cpu")
    js.set_data(data)
    ts.set_data(data)
    return js, ts


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=0)


def test_layout_keeps_an_empty_kde_segment():
    """The KDE signal leaves no MC rows: an empty segment beside the
    histogram's in B1's layout, whose plain version bins nothing into
    it; no fused kernel takes the stack; a KDE that no systematic
    touches leaves no segment at all."""
    _, ts = _stacks(exact=False)
    assert ts.has_kde and not ts.supports_fused
    hs = ts.hist_spec
    assert hs.seg_off == (0, 0, 2000) and ts._dyn_idx == (0, 1)
    counts, norms = kernels.segmented_histogram(
        hs, ts.samples, torch.tensor([0.3]))
    assert float(counts[0].sum()) == 0.0 and float(norms[0]) == 0.0
    assert float(norms[1]) == float(counts[1].sum()) > 0
    _, ts0 = _stacks(exact=False, syst=False)
    assert ts0.hist_spec is None and ts0._static_idx == (1,)


@pytest.mark.parametrize("exact", [False, True])
def test_histograms_match_jax(exact):
    """histograms() and histograms_batch(): the histogram row equal, the
    KDE row the KDE's grid pseudo-counts."""
    import jax.numpy as jnp

    js, ts = _stacks(exact)
    for th in THETAS:
        jh, jn = js.histograms(jnp.asarray([th], jnp.float32))
        th_, tn = ts.histograms(torch.tensor([th]))
        assert np.array_equal(th_[1].numpy(), np.asarray(jh)[1])
        _close(th_[0].numpy(), np.asarray(jh)[0])
        assert np.array_equal(tn.numpy(), np.asarray(jn))
    hb, nb = ts.histograms_batch(torch.tensor([[0.0], [0.3]]))
    for c, th in enumerate(THETAS):
        h1, n1 = ts.histograms(torch.tensor([th]))
        assert torch.equal(hb[c], h1) and torch.equal(nb[c], n1)


@pytest.mark.parametrize("exact", [False, True])
def test_evaluate_matches_jax(exact):
    """evaluate() with and without use_exact_kde: the LUT and norms;
    exact rows differ from the grid ones (the override happened)."""
    import jax.numpy as jnp

    js, ts = _stacks(exact)
    for th in THETAS:
        for use in (False, True):
            jl, jn = js.evaluate(jnp.asarray([th], jnp.float32),
                                 use_exact_kde=use)
            tl, tn = ts.evaluate(torch.tensor([th]), use_exact_kde=use)
            _close(tl.numpy(), jl)
            assert np.array_equal(tn.numpy(), np.asarray(jn))
    grid, _ = ts.evaluate(torch.tensor([0.3]))
    ex, _ = ts.evaluate(torch.tensor([0.3]), use_exact_kde=True)
    changed = not torch.equal(torch.nan_to_num(grid[0]),
                              torch.nan_to_num(ex[0]))
    assert changed == exact


def test_evaluate_batch_matches_single_and_jax():
    """evaluate_batch() with exact rows: each chain's row as evaluate()
    gives it, and as the JAX package's batch."""
    import jax.numpy as jnp

    js, ts = _stacks(exact=True)
    thetas = np.asarray([[0.0], [0.3], [-0.2]], np.float32)
    tl, tn = ts.evaluate_batch(torch.as_tensor(thetas), use_exact_kde=True)
    jl, jn = js.evaluate_batch(jnp.asarray(thetas), use_exact_kde=True)
    _close(tl.numpy(), jl)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    for c in range(3):
        l1, n1 = ts.evaluate(torch.as_tensor(thetas[c]), use_exact_kde=True)
        assert torch.equal(torch.isnan(tl[c]), torch.isnan(l1))
        torch.testing.assert_close(torch.nan_to_num(tl[c]),
                                   torch.nan_to_num(l1), rtol=0, atol=0)
        assert torch.equal(tn[c], n1)


def test_binned_exact_kde_refused():
    """The binned likelihood refuses kde_exact rows with the JAX
    package's message; the grid KDE runs binned."""
    from sxmc_tpu.mcmc import metropolis as jm

    with pytest.raises(ValueError) as want:
        jm.MCMC(*make_kde_inputs("sxmc_tpu", exact=True), binned=True)
    with pytest.raises(ValueError) as got:
        tm.MCMC(*make_kde_inputs("sxmc_tpu_torch", exact=True),
                device="cpu", binned=True)
    assert str(got.value) == str(want.value)
    mc = tm.MCMC(*make_kde_inputs("sxmc_tpu_torch", exact=False),
                 device="cpu", binned=True)
    ls = mc(make_kde_data(), 60, 0.2, generator=torch.Generator())
    assert np.isfinite(ls.samples).all() and ls.samples.shape == (36, 3)
