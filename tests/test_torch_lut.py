"""Kernel B2 (the LUT gather) and the split path against the JAX package.

``lut_eval_plain`` is held against ``pallas_eval_lut`` run in interpret
mode on identical numpy inputs: values within 1 ulp (rtol 2e-7; the
TPU kernel gathers through a one-hot float32 matmul, exact for integer
counts, then divides as the port does), sentinels exact.  The split
path (``PdfStack.evaluate`` / ``evaluate_batch``: B1, then B2) and
``EvalHist.eval`` are held against the JAX package's counterparts the
same way.  The card-only cases of B2 are in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sxmc_tpu.ops import pallas_hist
from sxmc_tpu_torch.ops import kernels

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them.
torch.set_num_threads(1)

RTOL = 2e-7  # one float32 ulp


def _assert_lut(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("seed,nseg,rows", [(0, 3, 3), (1, 1, 1),
                                            (2, 6, 2)])
def test_plain_lut_matches_pallas_interpret(seed, nseg, rows):
    rng = np.random.default_rng(seed)
    total = int(rng.integers(4, 300))
    counts = rng.integers(0, 40, (nseg, total)).astype(np.float32)
    norms = np.maximum(counts.sum(axis=1), 1.0).astype(np.float32)
    nev = int(rng.integers(50, 600))
    rb = rng.integers(-2, total, (rows, nev)).astype(np.int32)
    bin_volume = float(rng.uniform(0.01, 2.0))
    got = kernels.lut_eval(torch.as_tensor(counts), torch.as_tensor(norms),
                           torch.as_tensor(rb), bin_volume)
    # The JAX kernel takes one read-bin row per segment: rows repeat.
    rb_full = np.tile(rb, (nseg // rows, 1))
    want = pallas_hist.pallas_eval_lut(
        jnp.asarray(counts.reshape(-1)), jnp.asarray(norms),
        jnp.asarray(pallas_hist.pack_read_bins(rb_full, chunk=256)),
        total_nbins=total, nsegments=nseg, bin_volume=bin_volume,
        chunk=256, interpret=True)[:, :nev]
    _assert_lut(got.numpy(), want)
    assert np.isnan(got.numpy()[rb_full == -1]).all()
    assert (got.numpy()[rb_full == -2] == 0.0).all()


def test_lut_wrapper_checks_inputs():
    counts = torch.ones((4, 5))
    with pytest.raises(ValueError):  # 3 read-bin rows do not divide 4
        kernels.lut_eval(counts, torch.ones(4),
                         torch.zeros((3, 7), dtype=torch.int32), 1.0)
    with pytest.raises(TypeError):
        kernels.lut_eval(counts, torch.ones(4),
                         torch.zeros((2, 7), dtype=torch.int64), 1.0)


def test_evalhist_eval_matches_jax():
    from sxmc_tpu.pdf.evalhist import EvalHist as JaxEvalHist
    from sxmc_tpu_torch.ops.transforms import SCALE, SystematicDesc
    from sxmc_tpu.ops.transforms import SystematicDesc as JaxDesc

    rng = np.random.default_rng(5)
    mc = np.stack([rng.normal(10, 2, 5000), rng.normal(10, 2, 5000)],
                  axis=1).astype(np.float32)
    pts = np.stack([rng.uniform(4, 16, 700), rng.choice([0.0, 1.0], 700)],
                   axis=1).astype(np.float32)
    from sxmc_tpu_torch.pdf.evalhist import EvalHist

    t = EvalHist(mc, 2, 1, [5.0], [15.0], [25], device="cpu")
    j = JaxEvalHist(mc, 2, 1, [5.0], [15.0], [25])
    t.add_systematic(SystematicDesc(type=SCALE, obs=0, par_indices=(0,)))
    j.add_systematic(JaxDesc(type=SCALE, obs=0, par_indices=(0,)))
    for theta in ([0.0], [0.021]):
        tv, tn = t.eval_points(pts, theta)
        jv, jn = j.eval_points(pts, np.asarray(theta, np.float32))
        assert float(tn) == float(jn)
        _assert_lut(tv.numpy(), jv)


