"""sxmc_tpu_torch.pdf against the reference goldens and sxmc_tpu.pdf.

EvalHist golden numbers come from the original sxmc's tests
(test_pdfz.cpp:79-96, mirrored by tests/test_pdf_golden.py) and do not
depend on the framework.  PdfStack histograms must equal the JAX
package's exactly (integer counts from the same float32 bin math).
"""

import importlib

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.pdf.evalhist import EvalHist, PdfError

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them (with one thread per core
# in every worker these tests ran ten times slower under xdist).
torch.set_num_threads(1)

SAMPLES = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 1.1, -0.1], np.float32)
EVAL_POINTS = np.array([[-0.1, 0], [0.1, 0], [0.2, 0], [0.6, 0], [0.7, 0],
                        [1.2, 0]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def jax_compiles_unoptimised():
    """The JAX references of the port's tests are small programs, each
    run once or twice: XLA's optimisation passes cost more than they
    save, so a module that imports this fixture compiles them with most
    optimisations off (``jax_disable_most_optimizations``: the same
    functions, in interpret mode where they reach Pallas, at XLA's
    lowest optimisation level).  The setting is restored and the
    compile caches cleared when the module ends, so that no program
    compiled this way outlives it.  Nothing to do where jax is not
    installed."""
    try:
        import jax
    except ImportError:
        yield
        return
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()


def make_stack_inputs(pkg: str, seed: int = 3, n_mc: int = 3000,
                      nbins: int = 12, wide: bool = False, far: bool = False):
    """Three signals in package ``pkg`` (sxmc_tpu or sxmc_tpu_torch):
    "a" carries a scale and a resolution systematic, "b" only the
    scale, "c" none (a static row, on dataset 1).  ``wide``: a second
    observable "r" (4 bins on [0, 10)), and "a" and "b" also carry a
    resolution of r and a shift of the truth field "true" that both
    resolutions read, in the order a config loads them (r's resolution
    appends "true" to the sample fields, the shift acts on it, then
    energy's): two observables and a transformed field after them.
    ``far``: three spare sample fields between energy and "true" (six
    fields: energy, the spare ones, true, DATASET), and "a" and "b" also
    carry a shift of "true" ahead of their energy systematics, so that
    the resolution reads a transformed field 4 (nload = 5: a field past
    the first four).
    Returns ``(sources, signals, systematics, observables)``."""
    sig = importlib.import_module(pkg + ".signal")
    rng = np.random.default_rng(seed)
    obs = [sig.Observable(name="energy", field="energy", bins=nbins,
                          lower=5.0, upper=15.0, field_index=0)]
    nobs = 1
    if wide:
        obs.append(sig.Observable(name="r", field="r", bins=4, lower=0.0,
                                  upper=10.0, field_index=1))
        nobs = 2
    pnext = iter(range(8))
    nspare = 3 if far else 0
    pre = []
    if far:
        pre = [sig.Systematic(name="tshift", type=0,
                              observable_field="true", means=[0.0],
                              sigmas=[0.5], observable_field_index=4,
                              pidx=[next(pnext)])]
    if wide:
        pre = [sig.Systematic(name="rres", type=2, observable_field="r",
                              truth_field="true", means=[0.0],
                              sigmas=[0.01], observable_field_index=1,
                              truth_field_index=2, pidx=[next(pnext)]),
               sig.Systematic(name="tshift", type=0,
                              observable_field="true", means=[0.0],
                              sigmas=[0.5], observable_field_index=2,
                              pidx=[next(pnext)])]
    scale = sig.Systematic(name="scale", type=1, observable_field="energy",
                           means=[0.0], sigmas=[0.02],
                           observable_field_index=0, pidx=[next(pnext)])
    res = sig.Systematic(name="res", type=2, observable_field="energy",
                         truth_field="true", means=[0.0], sigmas=[0.01],
                         observable_field_index=0,
                         truth_field_index=nobs + nspare,
                         pidx=[next(pnext)])
    fields = ([o.field for o in obs] + [f"spare{i}" for i in range(nspare)]
              + ["true", "DATASET"])
    tables = []
    for mu in (10.0, 8.0, 12.0):
        true = rng.normal(mu, 1.5, n_mc).astype(np.float32)
        reco = (true + rng.normal(0, 0.6, n_mc)).astype(np.float32)
        cols = [reco]
        if wide:
            cols.append(rng.uniform(0.0, 10.0, n_mc).astype(np.float32))
        cols += [rng.normal(0.0, 1.0, n_mc).astype(np.float32)
                 for _ in range(nspare)]
        tables.append(np.stack(cols + [true], axis=1))
    srcs = [sig.Source(name=n, index=i, mean=1.0, sigma=s)
            for i, (n, s) in enumerate([("a", 0.0), ("b", 0.1),
                                        ("c", 0.05)])]
    plan = [("a", 0, 400.0, pre + [scale, res]), ("b", 0, 900.0,
                                                  pre + [scale]),
            ("c", 1, 300.0, [])]
    signals = [sig.Signal.from_table(name, name, tables[i], fields[:-1],
                                     ds, srcs[i], rate, fields, obs, [],
                                     systs)
               for i, (name, ds, rate, systs) in enumerate(plan)]
    return srcs, signals, pre + [scale, res], obs


def make_data(seed: int = 9, nev: int = 400, wide: bool = False):
    """Events on [4, 16) (some out of domain; wide: and r on [-1, 11))
    with tags 0, 1 and 7 (a tag no signal carries: -2 in every row)."""
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(4.0, 16.0, nev)]
    if wide:
        cols.append(rng.uniform(-1.0, 11.0, nev))
    tags = rng.choice(np.asarray([0.0, 1.0, 7.0], np.float32), nev,
                      p=[0.6, 0.3, 0.1])
    return np.stack(cols + [tags], axis=1).astype(np.float32)


class TestEvalHistGolden:
    def test_evaluation(self):
        ev = EvalHist(SAMPLES, 1, 1, [0.0], [1.0], [2], device="cpu")
        values, norm = ev.eval_points(EVAL_POINTS)
        assert float(norm) == 5.0
        values = values.numpy()
        assert np.isnan(values[0]) and np.isnan(values[5])
        np.testing.assert_allclose(values[1:5], [1.6, 1.6, 0.4, 0.4],
                                   rtol=1e-6)

    def test_dataset_mismatch_gives_zero(self):
        ev = EvalHist(SAMPLES, 1, 1, [0.0], [1.0], [2], dataset=1,
                      device="cpu")
        values = ev.eval_points(EVAL_POINTS)[0].numpy()
        assert np.isnan(values[0]) and np.isnan(values[5])
        np.testing.assert_array_equal(values[1:5], 0.0)

    def test_row_major_2d(self):
        samples = np.array([[0.1, 0.1], [0.2, 0.7], [0.3, 0.7], [0.6, 1.5],
                            [0.7, 1.5], [0.8, 1.5], [1.5, 0.5]], np.float32)
        ev = EvalHist(samples, 2, 2, [0.0, 0.0], [1.0, 2.0], [2, 3],
                      device="cpu")
        bins, norm = ev.histogram()
        assert float(norm) == 6.0
        np.testing.assert_array_equal(bins.numpy().reshape(2, 3),
                                      [[1, 2, 0], [0, 0, 3]])

    def test_systematic_moves_samples(self):
        from sxmc_tpu_torch.ops.transforms import SHIFT, SystematicDesc

        ev = EvalHist(SAMPLES, 1, 1, [0.0], [1.0], [2], device="cpu")
        ev.add_systematic(SystematicDesc(type=SHIFT, obs=0,
                                         par_indices=(0,)))
        bins, norm = ev.histogram([0.2])
        # +0.2: {0.3, 0.4} stay low, {0.5, 0.6, 0.7} high, 1.3 out,
        # -0.1 -> 0.1 in.
        np.testing.assert_array_equal(bins.numpy(), [3, 3])

    @pytest.mark.parametrize("kw", [dict(nfields=2), dict(nobservables=0),
                                    dict(lower=[0.0, 0.0]),
                                    dict(nbins=[0])])
    def test_validation(self, kw):
        args = dict(samples=SAMPLES, nfields=1, nobservables=1,
                    lower=[0.0], upper=[1.0], nbins=[2], device="cpu")
        args.update(kw)
        with pytest.raises(PdfError):
            EvalHist(**args)


def _stack_pair(**layout):
    from sxmc_tpu.pdf.stack import PdfStack as JaxStack
    from sxmc_tpu_torch.pdf.stack import PdfStack

    _, jsig, jsyst, jobs = make_stack_inputs("sxmc_tpu", **layout)
    _, tsig, tsyst, tobs = make_stack_inputs("sxmc_tpu_torch", **layout)
    return JaxStack(jsig, jobs, jsyst), PdfStack(tsig, tobs, tsyst, "cpu")


@pytest.fixture(scope="module")
def stacks():
    return _stack_pair()


@pytest.fixture(scope="module")
def wide_stacks():
    return _stack_pair(wide=True)


@pytest.fixture(scope="module")
def far_stacks():
    return _stack_pair(far=True)


# (nobs, nfields, nload) of each layout's dynamic rows.
LAYOUT_FIELDS = {"wide": (2, 4, 3), "far": (1, 6, 5)}


class TestPdfStackAgainstJax:
    def test_static_dynamic_split(self, stacks):
        _, t = stacks
        assert t._dyn_idx == (0, 1) and t._static_idx == (2,)
        assert t.sig_slot == (0, 1, -1)
        assert t.hist_spec.seg_off == (0, 3000, 6000)

    @pytest.mark.parametrize("theta", [[0.0, 0.0], [0.013, -0.004],
                                       [-0.05, 0.02]])
    def test_histograms_match_jax(self, stacks, theta):
        j, t = stacks
        jh, jn = j.histograms(np.asarray(theta, np.float32))
        th, tn = t.histograms(np.asarray(theta, np.float32))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))

    def test_read_bins_match_jax(self, stacks):
        j, t = stacks
        data = make_data()
        np.testing.assert_array_equal(
            t.compute_read_bins(data).numpy(),
            np.asarray(j.compute_read_bins(data)))

    @pytest.mark.parametrize(
        "layout, theta",
        [("wide", [0.0, 0.0, 0.0, 0.0]), ("wide", [0.004, 0.7, 0.013, -0.004]),
         ("wide", [-0.02, -1.3, -0.05, 0.02]), ("far", [0.0, 0.0, 0.0]),
         ("far", [0.7, 0.013, -0.004]), ("far", [-1.3, -0.05, 0.02])],
        ids=["theta0", "theta1", "theta2", "far-theta0", "far-theta1",
             "far-theta2"])
    def test_wide_histograms_match_jax(self, request, layout, theta):
        """Wide: two observables, and a shift of the truth field that
        both resolutions read (the kernels' general binning).  Far: the
        resolution reads a shifted field 4, past the first four."""
        j, t = request.getfixturevalue(layout + "_stacks")
        hs = t.hist_spec
        assert (hs.nobs, hs.nfields, hs.nload) == LAYOUT_FIELDS[layout]
        jh, jn = j.histograms(np.asarray(theta, np.float32))
        th, tn = t.histograms(np.asarray(theta, np.float32))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))

    def test_wide_truth_shift_moves_samples(self, wide_stacks):
        """The truth shift changes what the resolutions read, so it
        moves samples (else the cases above would not test it)."""
        _, t = wide_stacks
        th0, _ = t.histograms(np.asarray([0.02, 0.0, 0.0, 0.03],
                                         np.float32))
        th1, _ = t.histograms(np.asarray([0.02, 1.5, 0.0, 0.03],
                                         np.float32))
        assert not torch.equal(th0, th1)

    def test_far_truth_shift_moves_samples(self, far_stacks):
        """The same for the shift of field 4 in the far layout."""
        _, t = far_stacks
        th0, _ = t.histograms(np.asarray([0.0, 0.0, 0.03], np.float32))
        th1, _ = t.histograms(np.asarray([1.5, 0.0, 0.03], np.float32))
        assert not torch.equal(th0, th1)

    def test_wide_read_bins_match_jax(self, wide_stacks):
        j, t = wide_stacks
        data = make_data(wide=True)
        np.testing.assert_array_equal(
            t.compute_read_bins(data).numpy(),
            np.asarray(j.compute_read_bins(data)))
