"""sxmc_tpu_torch.ops against sxmc_tpu.ops on identical numpy inputs.

Systematics, bin ids and histograms must agree exactly: both packages
do the same float32 operations in the same order (histogram counts are
integers).  NLL values are held to |dNLL| <= 1e-3 absolute: XLA's CPU
``log`` and torch's differ by about an ulp per event, and the port sums
in float64 where the JAX package carries compensated float32 pairs;
1e-3 is far below the 0.5 dNLL the intervals resolve.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sxmc_tpu.ops import histogram as j_hist
from sxmc_tpu.ops import nll as j_nll
from sxmc_tpu.ops import transforms as j_tr
from sxmc_tpu_torch.ops import histogram as t_hist
from sxmc_tpu_torch.ops import nll as t_nll
from sxmc_tpu_torch.ops import transforms as t_tr
from sxmc_tpu_torch.pdf.evalhist import eval_from_bins

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them (with one thread per core
# in every worker these tests ran ten times slower under xdist).
torch.set_num_threads(1)

NLL_TOL = 1e-3  # absolute; see the module docstring


def _descs(mod, kind):
    """One systematic of each type: a 2-term power series on field 0,
    truth field 1 for the resolution scale."""
    return [mod.SystematicDesc(type=kind, obs=0, par_indices=(0, 1),
                               extra_field=1)]


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(11)
    x = rng.uniform(4.0, 16.0, (4000, 3)).astype(np.float32)
    x[:, 1] = (x[:, 0] + rng.normal(0, 0.5, 4000)).astype(np.float32)
    return x


@pytest.mark.parametrize("kind", [j_tr.SHIFT, j_tr.SCALE,
                                  j_tr.RESOLUTION_SCALE, j_tr.CTSCALE])
def test_transform_matches_jax(samples, kind):
    theta = np.asarray([0.03, -0.002], np.float32)
    want = np.asarray(j_tr.apply_systematics(
        jnp.asarray(samples), jnp.asarray(theta), _descs(j_tr, kind)))
    got = t_tr.apply_systematics(torch.as_tensor(samples),
                                 torch.as_tensor(theta),
                                 _descs(t_tr, kind)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sequential_systematics_match_jax(samples):
    theta = np.asarray([0.01, 0.02, -0.03, 0.005], np.float32)
    kinds = [j_tr.SCALE, j_tr.SHIFT, j_tr.CTSCALE, j_tr.RESOLUTION_SCALE]

    def descs(mod):
        return [mod.SystematicDesc(type=k, obs=0, par_indices=(i,),
                                   extra_field=1)
                for i, k in enumerate(kinds)]

    want = np.asarray(j_tr.apply_systematics(
        jnp.asarray(samples), jnp.asarray(theta), descs(j_tr)))
    got = t_tr.apply_systematics(torch.as_tensor(samples),
                                 torch.as_tensor(theta), descs(t_tr))
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_points():
    """Random 2-D points plus points exactly on, and one float32 ulp
    either side of, every bin edge: the rounding-sensitive cases."""
    rng = np.random.default_rng(5)
    lower, upper, nbins = (5.0, 0.0), (15.0, 2.0), (7, 3)
    pts = rng.uniform(-1, 17, (3000, 2)).astype(np.float32)
    edges = []
    for a in range(2):
        e = np.linspace(lower[a], upper[a], nbins[a] + 1).astype(np.float32)
        e = np.concatenate([e, np.nextafter(e, np.float32(-np.inf)),
                            np.nextafter(e, np.float32(np.inf))])
        # XLA on the CPU flushes float32 subnormals to zero, torch and
        # CUDA keep them: the ulp neighbours of an edge at 0 differ by
        # design, so they are left out.
        e = e[(e == 0) | (np.abs(e) >= np.finfo(np.float32).tiny)]
        col = np.full((e.size, 2), np.float32(lower[1 - a] + 0.3))
        col[:, a] = e
        edges.append(col)
    return np.concatenate([pts] + edges).astype(np.float32), lower, upper, \
        nbins


def test_bin_ids_match_jax_on_edges():
    pts, lower, upper, nbins = _edge_points()
    j_ids, j_valid = j_hist.compute_bin_ids(
        jnp.asarray(pts), jnp.asarray(lower, jnp.float32),
        jnp.asarray(upper, jnp.float32), nbins)
    t_ids, t_valid = t_hist.compute_bin_ids(torch.as_tensor(pts), lower,
                                            upper, nbins)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))


def test_segmented_histogram_matches_jax():
    pts, lower, upper, nbins = _edge_points()
    seg = (np.arange(pts.shape[0]) % 3).astype(np.int32)
    j_h, j_n = j_hist.segmented_histogram(
        jnp.asarray(pts), jnp.asarray(seg), jnp.ones(pts.shape[0], bool),
        jnp.asarray(lower, jnp.float32), jnp.asarray(upper, jnp.float32),
        nbins, 3)
    ids, valid = t_hist.compute_bin_ids(torch.as_tensor(pts), lower, upper,
                                        nbins)
    got = t_hist.segmented_histogram(ids, valid, torch.as_tensor(seg), 3,
                                     t_hist.total_bins(nbins))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_h))
    np.testing.assert_array_equal(got.sum(1).numpy(), np.asarray(j_n))
    assert t_hist.bin_strides(nbins) == j_hist.bin_strides(nbins)
    assert t_hist.bin_volume(lower, upper, nbins) == \
        j_hist.bin_volume(lower, upper, nbins)


def _static(nsig=2, npar=3):
    return t_nll.NLLStatic(
        nexpected=np.asarray([300.0, 700.0][:nsig], np.float32),
        n_mc=np.asarray([1e4, 2e4][:nsig], np.float32),
        source_id=np.asarray([0, 1][:nsig], np.int32),
        means=np.asarray([1.0, 1.0, 0.0][:npar], np.float32),
        sigmas=np.asarray([0.0, 0.1, 0.02][:npar], np.float32),
        nsources=2)


def _consts(st):
    """The port's NLL functions take the constants as device tensors."""
    return t_nll.device_consts(st, "cpu")


def _jax_static(st):
    return j_nll.NLLStatic(st.nexpected, st.n_mc, st.source_id, st.means,
                           st.sigmas, st.nsources)


@pytest.fixture(scope="module")
def lut():
    rng = np.random.default_rng(3)
    lut = rng.uniform(0.0, 2.0, (2, 5000)).astype(np.float32)
    lut[0, ::17] = np.nan     # out-of-domain sentinel
    lut[1, ::29] = 0.0        # dataset-mismatch sentinel
    lut[:, ::101] = 0.0       # an event no signal explains: s == 0
    return lut


@pytest.mark.parametrize("pars", [[1.0, 1.0, 0.0], [1.3, 0.8, 0.015],
                                  [0.2, 1.7, -0.03]])
def test_nll_pair_matches_jax(lut, pars):
    st = _static()
    pars = np.asarray(pars, np.float32)
    norms = np.asarray([9500.0, 18100.0], np.float32)
    jh, jl = j_nll.nll_pair(jnp.asarray(pars), jnp.asarray(lut),
                            jnp.asarray(norms), _jax_static(st))
    th, tl = t_nll.nll_pair(torch.as_tensor(pars), torch.as_tensor(lut),
                            torch.as_tensor(norms), _consts(st))
    want = float(np.float64(jh) + np.float64(jl))
    got = float(th.double() + tl.double())
    assert abs(got - want) <= NLL_TOL, (got, want)


def test_nan_sentinel_counts_as_zero(lut):
    st = _static()
    pars = torch.as_tensor([1.1, 0.9, 0.01])
    norms = torch.as_tensor([9500.0, 18100.0])
    a = t_nll.nll(pars, torch.as_tensor(lut), norms, _consts(st))
    b = t_nll.nll(pars, torch.as_tensor(np.nan_to_num(lut)), norms,
                  _consts(st))
    assert float(a) == float(b)


def test_barrier_on_negative_rate(lut):
    st = _static()
    hi, lo = t_nll.nll_pair(torch.as_tensor([-0.1, 1.0, 0.0]),
                            torch.as_tensor(lut),
                            torch.as_tensor([9500.0, 18100.0]), _consts(st))
    assert float(hi) == float(np.float32(1e18)) and float(lo) == 0.0


def test_barrier_on_nonfinite_event_sum():
    st = _static()
    pars = torch.as_tensor([1.0, 1.0, 0.0])
    w = torch.as_tensor([1.0, 2.0])
    hi, lo = t_nll.finish_nll(pars, torch.tensor(float("inf")),
                              torch.tensor(0.0), w, _consts(st))
    jhi, jlo = j_nll.finish_nll(jnp.asarray(pars.numpy()), jnp.float32(
        np.inf), jnp.float32(0.0), jnp.asarray(w.numpy()), _jax_static(st))
    assert float(hi) == float(jhi) == float(np.float32(1e18))
    assert float(lo) == float(jlo) == 0.0


def test_finish_matches_jax():
    st = _static()
    pars = np.asarray([1.2, 0.7, 0.013], np.float32)
    w = np.asarray([123.5, 456.25], np.float32)
    jh, jl = j_nll.finish_nll(jnp.asarray(pars), jnp.float32(-2345.678),
                              jnp.float32(1e-5), jnp.asarray(w),
                              _jax_static(st))
    th, tl = t_nll.finish_nll(torch.as_tensor(pars),
                              torch.tensor(-2345.678),
                              torch.tensor(1e-5), torch.as_tensor(w),
                              _consts(st))
    assert abs(float(th.double() + tl.double())
               - float(np.float64(jh) + np.float64(jl))) <= NLL_TOL


def test_df_helpers_match_jax():
    a = (np.float32(1.2345678e7), np.float32(0.37))
    b = (np.float32(1.2345677e7), np.float32(-0.21))
    targs = [torch.tensor(x) for x in a + b]
    jargs = [jnp.float32(x) for x in a + b]
    assert float(t_nll.df_diff(*targs)) == float(j_nll.df_diff(*jargs))
    th, tl = t_nll.df_add(*targs)
    jh, jl = j_nll.df_add(*jargs)
    assert (float(th), float(tl)) == (float(jh), float(jl))


def test_eval_from_bins_sentinels():
    bins = torch.as_tensor([4.0, 1.0])
    rb = torch.as_tensor([0, 1, -1, -2], dtype=torch.int32)
    v = eval_from_bins(bins, torch.tensor(5.0), 0.5, rb).numpy()
    np.testing.assert_allclose(v[:2], [1.6, 0.4], rtol=1e-6)
    assert np.isnan(v[2]) and v[3] == 0.0


class TestPrecisionAtScale:
    """Mirror of test_nll_precision.py::TestNllPairAtScale: 2M events,
    NLL ~ 5e6, where the float32 quantum (0.5) is already fatal."""

    @pytest.fixture(scope="class")
    def fit(self):
        rng = np.random.default_rng(41)
        nev = 2_000_000
        lut = rng.uniform(0.2, 1.8, (2, nev)).astype(np.float32)
        st = t_nll.NLLStatic(
            nexpected=np.asarray([0.6 * nev, 0.4 * nev], np.float32),
            n_mc=np.asarray([1e6, 1e6], np.float32),
            source_id=np.asarray([0, 1], np.int32),
            means=np.asarray([1.0, 1.0], np.float32),
            sigmas=np.asarray([0.0, 0.1], np.float32), nsources=2)
        norms = np.asarray([1e6, 1e6], np.float32)
        jf = jax.jit(lambda p, l: j_nll.nll_pair(
            p, l, jnp.asarray(norms), _jax_static(st)))
        return lut, norms, st, jf, jnp.asarray(lut)

    @staticmethod
    def _port(fit, pars):
        lut, norms, st, _, _ = fit
        hi, lo = t_nll.nll_pair(torch.as_tensor(pars), torch.as_tensor(lut),
                                torch.as_tensor(norms), _consts(st))
        return float(hi.double() + lo.double())

    @staticmethod
    def _host_f64(fit, pars):
        lut, norms, st, _, _ = fit
        w32 = (pars.astype(np.float64) * st.nexpected * norms
               / st.n_mc).astype(np.float32)
        s = (w32[:, None] * lut).sum(0, dtype=np.float32)
        total = -np.log(s.astype(np.float64)).sum() + w32.sum(
            dtype=np.float64)
        z = (pars[1] - 1.0) / 0.1
        return total + 0.5 * z * z

    def test_value_matches_jax_and_f64(self, fit):
        pars = np.asarray([1.0, 1.0], np.float32)
        hi, lo = fit[3](pars, fit[4])
        want_jax = float(np.float64(hi) + np.float64(lo))
        got = self._port(fit, pars)
        assert abs(want_jax) > 1e6
        assert abs(got - want_jax) <= NLL_TOL, (got, want_jax)
        assert abs(got - self._host_f64(fit, pars)) < 0.05

    def test_dnll_resolves_interval_scale(self, fit):
        p0 = np.asarray([1.0, 1.0], np.float32)
        for eps in (1e-4, 1e-3):
            p1 = np.asarray([1.0 + eps, 1.0], np.float32)
            got = self._port(fit, p1) - self._port(fit, p0)
            want = self._host_f64(fit, p1) - self._host_f64(fit, p0)
            assert abs(got - want) < 0.02, (eps, got, want)
            assert got != 0.0
