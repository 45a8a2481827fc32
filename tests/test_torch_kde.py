"""sxmc_tpu_torch.pdf.evalkde against sxmc_tpu.pdf.evalkde.

The same numpy samples and points go through both packages' EvalKDE:
grid pseudo-counts and norms, and exact densities, in one and two
observables, with and without systematics.  Tolerance rtol 2e-5: the
density at a point z bandwidths from the nearest samples is a sum of
exp(-z^2 / 2) terms, so a one-ulp difference in a transformed sample or
in the bandwidth (XLA and torch fuse and reduce in other orders) moves
it by ~z^2 x 6e-8 relative; the far tails of the grid (z ~ 10) reach
~1e-5.  Norms are counts and must be equal.

``make_kde_inputs`` / ``make_kde_data`` are the KDE fits' inputs for
the other KDE test files and tests/data/kde_reference/make_reference.py.
"""

import importlib

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.pdf import evalkde as tk
from sxmc_tpu_torch.pdf.evalhist import PdfError
from sxmc_tpu_torch.ops.transforms import SystematicDesc

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

RTOL = 2e-5


def make_kde_inputs(pkg: str, exact: bool = False, syst: bool = True,
                    n_sig: int = 400, n_bkg: int = 2000, seed: int = 2):
    """A KDE signal "sig" (a Gaussian of ``n_sig`` samples) beside a
    histogram "bkg" (flat, ``n_bkg`` samples) in package ``pkg``, a
    floating shift acting on both when ``syst``.  Returns ``(sources,
    signals, systematics, observables)``."""
    sig = importlib.import_module(pkg + ".signal")
    rng = np.random.default_rng(seed)
    obs = [sig.Observable(name="energy", field="energy", bins=25,
                          lower=5.0, upper=15.0, field_index=0)]
    systs = ([sig.Systematic(name="shift", type=0, observable_field="energy",
                             means=[0.0], sigmas=[0.05],
                             observable_field_index=0, pidx=[0])]
             if syst else [])
    fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10.0, 1.0, (n_sig, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5.0, 15.0, (n_bkg, 1)).astype(np.float32)
    srcs = [sig.Source(name="sig", index=0, mean=1.0, sigma=0.0),
            sig.Source(name="bkg", index=1, mean=1.0, sigma=0.1)]
    signals = [
        sig.Signal.from_table("sig", "S", sig_mc, ["energy"], 0, srcs[0],
                              200.0, fields, obs, [], systs, kde=True,
                              kde_exact=exact),
        sig.Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, srcs[1],
                              400.0, fields, obs, [], systs)]
    return srcs, signals, systs, obs


def make_kde_data(seed: int = 11, nev: int = 150):
    """Events on [4, 16) (some out of domain), tags 0 and 7 (a tag no
    signal carries)."""
    rng = np.random.default_rng(seed)
    e = np.concatenate([rng.normal(10.0, 1.0, nev // 3),
                        rng.uniform(4.0, 16.0, nev - nev // 3)])
    tags = rng.choice(np.asarray([0.0, 7.0]), nev, p=[0.9, 0.1])
    return np.stack([e, tags], axis=1).astype(np.float32)


def _pair(nobs: int, syst: bool):
    """The same KDE in both packages: one observable (energy), or two
    (energy, r) with a truth field; systematics: a shift of energy, and
    with two observables a resolution of r."""
    import sxmc_tpu.pdf.evalkde as jk
    from sxmc_tpu.ops.transforms import SystematicDesc as JDesc

    rng = np.random.default_rng(5)
    n = 700
    cols = [rng.normal(10.0, 1.0, n)]
    if nobs == 2:
        true_r = rng.uniform(0.0, 10.0, n)
        cols += [true_r + rng.normal(0, 0.5, n), true_r]
    x = np.stack(cols + [np.zeros(n)], axis=1).astype(np.float32)
    lower, upper = [5.0, 0.0][:nobs], [15.0, 10.0][:nobs]
    nbins = [12, 5][:nobs]
    descs = []
    if syst:
        descs.append((0, 0, (0,), 0))
        if nobs == 2:
            descs.append((2, 1, (1,), 2))
    bw = [1.0, 0.7][:nobs]
    j = jk.EvalKDE(x, x.shape[1], nobs, lower, upper, bandwidth_scale=bw,
                   nbins=nbins)
    t = tk.EvalKDE(x, x.shape[1], nobs, lower, upper, bandwidth_scale=bw,
                   nbins=nbins, device="cpu")
    for typ, ob, pidx, extra in descs:
        j.add_systematic(JDesc(typ, ob, pidx, extra))
        t.add_systematic(SystematicDesc(typ, ob, pidx, extra))
    npar = len(descs)
    thetas = [np.zeros(npar, np.float32)]
    if npar:
        thetas.append(np.asarray([0.3, 0.05][:npar], np.float32))
    pts = np.stack(
        [rng.uniform(4.0, 16.0, 120)] + ([rng.uniform(-1.0, 11.0, 120)]
                                         if nobs == 2 else [])
        + [rng.choice([0.0, 3.0], 120, p=[0.85, 0.15])],
        axis=1).astype(np.float32)
    return j, t, thetas, pts


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=0)


@pytest.mark.parametrize("nobs", [1, 2])
def test_grid_matches_jax(nobs):
    """histogram(): pseudo-counts on the bin-centre grid and the
    in-domain norm, without and with systematics."""
    import jax.numpy as jnp

    for syst in (False, True):
        j, t, thetas, _ = _pair(nobs, syst)
        for th in thetas:
            jc, jn = j.histogram(jnp.asarray(th))
            tc, tn = t.histogram(th)
            _close(tc.numpy(), jc)
            assert float(tn) == float(jn)
        assert tc.shape == (int(np.prod(t.nbins)),)


@pytest.mark.parametrize("nobs", [1, 2])
def test_exact_matches_jax(nobs):
    """eval_points(): the exact density at points, some out of domain
    and some of another dataset."""
    import jax.numpy as jnp

    for syst in (False, True):
        j, t, thetas, pts = _pair(nobs, syst)
        for th in thetas:
            jd, jn = j.eval_points(pts, jnp.asarray(th) if syst else None)
            td, tn = t.eval_points(pts, th if syst else None)
            _close(td.numpy(), jd)
            assert float(tn) == float(jn)


def test_sentinels_and_refusals():
    """Out of domain NaN, dataset mismatch 0, both NaN (JAX's order);
    eval() raises; weights and a wrong bandwidth_scale are refused."""
    x = np.random.default_rng(0).normal(0.5, 0.2, (50, 2)).astype(np.float32)
    x[:, 1] = 0.0
    kde = tk.EvalKDE(x, 2, 1, [0.0], [1.0], device="cpu")
    pts = np.asarray([[0.5, 0.0], [0.5, 1.0], [1.5, 0.0], [1.5, 1.0],
                      [-0.1, 1.0]], np.float32)
    d, norm = kde.eval_points(pts)
    d = d.numpy()
    assert d[0] > 0 and d[1] == 0.0
    assert np.isnan(d[2]) and np.isnan(d[3]) and np.isnan(d[4])
    assert float(norm) == float(((x[:, 0] >= 0) & (x[:, 0] < 1)).sum())
    with pytest.raises(NotImplementedError, match="eval_points"):
        kde.eval(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(PdfError, match="weighted"):
        tk.EvalKDE(x, 2, 1, [0.0], [1.0], weights=np.ones(50),
                   device="cpu")
    with pytest.raises(PdfError, match="bandwidth_scale"):
        tk.EvalKDE(x, 2, 1, [0.0], [1.0], bandwidth_scale=[1.0, 2.0],
                   device="cpu")
    assert kde.nbins == (64,)  # the default grid


def test_bin_centres_and_blocks():
    """The grid is JAX's bin centres in row-major order, and the block
    size does not change the density (blocks of 1 point, of 7, of
    all)."""
    import sxmc_tpu.pdf.evalkde as jk

    args = ([0.0, -1.0, 2.0], [1.0, 1.0, 5.0], [3, 4, 2], 1)
    assert np.array_equal(tk._bin_center_points(*args),
                          jk._bin_center_points(*args))
    _, t, thetas, pts = _pair(2, True)
    samples = t.device_samples()
    p = torch.as_tensor(pts)
    th = torch.as_tensor(thetas[-1])
    full, _ = tk.kde_eval(samples, p, th, t)
    for nbytes in (4 * 700 * 2, 7 * 4 * 700 * 2):
        got, _ = tk.kde_eval(samples, p, th, t, block_bytes=nbytes)
        assert torch.equal(torch.isnan(got), torch.isnan(full))
        ok = ~torch.isnan(full)
        torch.testing.assert_close(got[ok], full[ok], rtol=1e-6, atol=0)


def test_gradient_through_blocks_is_finite():
    """With autograd on, the blocks are checkpointed: the gradient in
    theta of a sum of densities equals the one without blocks."""
    _, t, thetas, pts = _pair(1, True)
    samples = t.device_samples()
    p = torch.as_tensor(pts)
    grads = []
    for nbytes in (tk.KDE_BLOCK_BYTES, 4 * 700 * 16):
        th = torch.as_tensor(thetas[-1]).requires_grad_(True)
        d, _ = tk.kde_eval(samples, p, th, t, block_bytes=nbytes)
        torch.nan_to_num(d, nan=0.0).sum().backward()
        grads.append(th.grad.clone())
    assert torch.isfinite(grads[0]).all() and float(grads[0].abs()) > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=0)

