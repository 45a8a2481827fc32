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


def make_stack_inputs(pkg: str, seed: int = 3, n_mc: int = 3000,
                      nbins: int = 12):
    """Three signals in package ``pkg`` (sxmc_tpu or sxmc_tpu_torch):
    "a" carries a scale and a resolution systematic, "b" only the
    scale, "c" none (a static row, on dataset 1).  Returns
    ``(sources, signals, systematics, observables)``."""
    sig = importlib.import_module(pkg + ".signal")
    rng = np.random.default_rng(seed)
    obs = sig.Observable(name="energy", field="energy", bins=nbins,
                         lower=5.0, upper=15.0, field_index=0)
    scale = sig.Systematic(name="scale", type=1, observable_field="energy",
                           means=[0.0], sigmas=[0.02],
                           observable_field_index=0, pidx=[0])
    res = sig.Systematic(name="res", type=2, observable_field="energy",
                         truth_field="true", means=[0.0], sigmas=[0.01],
                         observable_field_index=0, truth_field_index=1,
                         pidx=[1])
    fields = ["energy", "true", "DATASET"]
    tables = []
    for mu in (10.0, 8.0, 12.0):
        true = rng.normal(mu, 1.5, n_mc).astype(np.float32)
        reco = (true + rng.normal(0, 0.6, n_mc)).astype(np.float32)
        tables.append(np.stack([reco, true], axis=1))
    srcs = [sig.Source(name=n, index=i, mean=1.0, sigma=s)
            for i, (n, s) in enumerate([("a", 0.0), ("b", 0.1),
                                        ("c", 0.05)])]
    plan = [("a", 0, 400.0, [scale, res]), ("b", 0, 900.0, [scale]),
            ("c", 1, 300.0, [])]
    signals = [sig.Signal.from_table(name, name, tables[i], ["energy",
                                                             "true"],
                                     ds, srcs[i], rate, fields, [obs], [],
                                     systs)
               for i, (name, ds, rate, systs) in enumerate(plan)]
    return srcs, signals, [scale, res], [obs]


def make_data(seed: int = 9, nev: int = 400):
    """Events on [4, 16) (some out of domain) with tags 0, 1 and 7 (a
    tag no signal carries: -2 in every row)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(4.0, 16.0, nev).astype(np.float32)
    tags = rng.choice(np.asarray([0.0, 1.0, 7.0], np.float32), nev,
                      p=[0.6, 0.3, 0.1])
    return np.stack([x, tags], axis=1).astype(np.float32)


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


@pytest.fixture(scope="module")
def stacks():
    from sxmc_tpu.pdf.stack import PdfStack as JaxStack
    from sxmc_tpu_torch.pdf.stack import PdfStack

    _, jsig, jsyst, jobs = make_stack_inputs("sxmc_tpu")
    _, tsig, tsyst, tobs = make_stack_inputs("sxmc_tpu_torch")
    return JaxStack(jsig, jobs, jsyst), PdfStack(tsig, tobs, tsyst, "cpu")


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
