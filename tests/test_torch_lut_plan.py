"""Kernel B2's plan (``kernels.LutPlan``) on the CPU.

The plan path is held against ``pallas_eval_lut`` run in interpret mode
on identical numpy inputs, with test_torch_lut.py's tolerance (one
float32 ulp, rtol 2e-7; NaN and 0 sentinels exact), with table rows
shared k = 8 ways and an event count that is not a multiple of 4; the
form choice as a pure function of the shape and a budget; the plan's
checks against ``lut_eval``'s exceptions; and ``PdfStack``'s plans.  The
kernel itself runs only on the card: test_torch_lut_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sxmc_tpu.ops import pallas_hist
from sxmc_tpu_torch.ops import kernels

from test_torch_lut import _assert_lut
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _inputs(seed, nseg, rows, nev):
    rng = np.random.default_rng(seed)
    total = int(rng.integers(4, 200))
    counts = rng.integers(0, 40, (nseg, total)).astype(np.float32)
    norms = np.maximum(counts.sum(axis=1), 1.0).astype(np.float32)
    rb = rng.integers(-2, total, (rows, nev)).astype(np.int32)
    return counts, norms, rb, float(rng.uniform(0.01, 2.0))


@pytest.mark.parametrize("seed,rows,k,nev", [(3, 2, 8, 1001), (4, 3, 1, 514)])
def test_plan_matches_pallas_interpret(seed, rows, k, nev):
    counts, norms, rb, bv = _inputs(seed, rows * k, rows, nev)
    plan = kernels.LutPlan(torch.as_tensor(rb), bv)
    got = plan(torch.as_tensor(counts), torch.as_tensor(norms))
    total = counts.shape[1]
    rb_full = np.tile(rb, (k, 1))
    want = pallas_hist.pallas_eval_lut(
        jnp.asarray(counts.reshape(-1)), jnp.asarray(norms),
        jnp.asarray(pallas_hist.pack_read_bins(rb_full, chunk=256)),
        total_nbins=total, nsegments=rows * k, bin_volume=bv, chunk=256,
        interpret=True)[:, :nev]
    _assert_lut(got.numpy(), want)
    assert np.isnan(got.numpy()[rb_full == -1]).all()
    assert (got.numpy()[rb_full == -2] == 0.0).all()
    # One plan serves every table shape on its read bins: its first k
    # table rows' rows equal a plan call on those rows alone, and the
    # plan equals lut_eval (a plan a call) bit for bit.
    sub = plan(torch.as_tensor(counts[:rows]), torch.as_tensor(norms[:rows]))
    assert torch.equal(torch.nan_to_num(sub), torch.nan_to_num(got[:rows]))
    again = kernels.lut_eval(torch.as_tensor(counts), torch.as_tensor(norms),
                             torch.as_tensor(rb), bv)
    assert torch.equal(torch.nan_to_num(again), torch.nan_to_num(got))
    assert torch.equal(torch.isnan(again), torch.isnan(got))


def test_lut_form_picks_l1_past_the_budget():
    """The form is a pure function of a row's bins, its events and the
    shared-memory budget: staged while one row's table fits, L1 past it
    (a budget of 0 takes L1 at any shape); four int4s of read bins a
    thread a tile from LUT_WIDE_EVENTS events.  The rows sharing a
    read-bin row do not enter: each block writes one table row."""
    budget = 227 * 1024
    wide = kernels.LUT_WIDE_EVENTS
    assert kernels.lut_form(10, 1464, budget) == (True, 1)
    assert kernels.lut_form(1000, 1_000_000, budget) == (True, 4)
    assert kernels.lut_form(budget // 4, wide - 1, budget) == (True, 1)
    assert kernels.lut_form(budget // 4 + 1, wide, budget) == (False, 4)
    assert kernels.lut_form(60_000, 1464, budget) == (False, 1)
    assert kernels.lut_form(10, 1464, 0) == (False, 1)
    for total in (1, 7, 12_000, 58_112, 58_113, 80_000):
        for b in (0, 48 * 1024, budget):
            for nev in (1, wide - 1, wide, 10**7):
                staged, vecs = kernels.lut_form(total, nev, b)
                assert staged == (4 * total <= b)
                assert vecs == (4 if nev >= wide else 1)


BAD = [
    # (counts, norms, read bins): each wrong in one way.
    (torch.ones((4, 5)), torch.ones(4), torch.zeros((3, 7), dtype=torch.int32)),
    (torch.ones((4, 5)), torch.ones(4), torch.zeros((2, 7), dtype=torch.int64)),
    (torch.ones((4, 5)), torch.ones(4), torch.zeros(7, dtype=torch.int32)),
    (torch.ones((4, 5)), torch.ones(4),
     torch.zeros((7, 2), dtype=torch.int32).T),
    (torch.ones(5), torch.ones(4), torch.zeros((2, 7), dtype=torch.int32)),
    (torch.ones((4, 5), dtype=torch.float64), torch.ones(4),
     torch.zeros((2, 7), dtype=torch.int32)),
    (torch.ones((5, 4)).T, torch.ones(4), torch.zeros((2, 7), dtype=torch.int32)),
    (torch.ones((4, 5)), torch.ones(3), torch.zeros((2, 7), dtype=torch.int32)),
    (torch.ones((4, 5)), torch.ones((4, 1)),
     torch.zeros((2, 7), dtype=torch.int32)),
    (torch.ones((4, 5)), torch.ones(4, dtype=torch.int32),
     torch.zeros((2, 7), dtype=torch.int32)),
    (torch.ones((4, 5)), torch.ones(8)[::2],
     torch.zeros((2, 7), dtype=torch.int32)),
    (torch.ones((4, 5)), torch.ones(4), torch.zeros((0, 7), dtype=torch.int32)),
    (torch.ones((4, 5)), [1.0] * 4, torch.zeros((2, 7), dtype=torch.int32)),
]


def _checks_before_plans(counts, norms, read_bins):
    """``lut_eval``'s checks as they were before plans, in their order."""
    dev = counts.device
    if counts.dim() != 2 or read_bins.dim() != 2:
        raise ValueError("counts must be (nseg, total) and read_bins "
                         "(r, nevents)")
    nseg, total = counts.shape
    kernels._expect(counts, "counts", (nseg, total), torch.float32, dev)
    kernels._expect(norms, "norms", (nseg,), torch.float32, dev)
    rows, nev = read_bins.shape
    if rows < 1 or nseg % rows:
        raise ValueError(f"{rows} read-bin rows do not divide {nseg} table "
                         "rows")
    kernels._expect(read_bins, "read_bins", (rows, nev), torch.int32, dev)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the type is the result)
        return type(e), str(e)
    return None


def test_plan_checks_raise_as_lut_eval():
    """Each bad input raises the exception, message and all, that
    lut_eval's checks raised before plans, through lut_eval and through a
    plan (made once, then called on a good table first, so that the bad
    call falls off the fast path)."""
    good = (torch.ones((4, 5)), torch.ones(4))
    for counts, norms, rb in BAD:
        want = _raised(lambda: _checks_before_plans(counts, norms, rb))
        assert want is not None and want[0] in (ValueError, TypeError)
        assert _raised(lambda: kernels.lut_eval(counts, norms, rb, 0.5)) \
            == want
        plan_made = _raised(lambda: kernels.LutPlan(rb, 0.5))
        if plan_made is not None:  # the read bins' own fault
            assert plan_made == want
            continue
        plan = kernels.LutPlan(rb, 0.5)
        if _raised(lambda: plan(*good)) is None:
            assert _raised(lambda: plan(counts, norms)) == want
        assert _raised(lambda: kernels.LutPlan(rb, 0.5)(counts, norms)) \
            == want


def test_stack_plans_follow_its_read_bins():
    """PdfStack makes the plan of set_data's read bins once and evaluates
    through it; another read-bins tensor gets its own plan, and the last
    two asked for are kept (a side fit's and the fit's)."""
    from sxmc_tpu_torch.pdf.stack import PdfStack

    _, sig, syst, obs = make_stack_inputs("sxmc_tpu_torch")
    st = PdfStack(sig, obs, syst, "cpu")
    st.set_data(make_data())
    plan = st.lut_plan(st.read_bins)
    assert plan.read_bins is st.read_bins
    theta = torch.as_tensor([0.011, -0.006])
    lut, norms = st.evaluate(theta)
    hists, _ = st.histograms(theta)
    want = kernels.lut_eval(hists, norms, st.read_bins, st.bin_volume)
    assert torch.equal(torch.nan_to_num(lut), torch.nan_to_num(want))
    side = st.compute_read_bins(make_data(nev=37))
    side_plan = st.lut_plan(side)
    assert side_plan is not plan and st.lut_plan(side) is side_plan
    assert st.lut_plan(st.read_bins) is plan
    st.lut_plan(st.compute_read_bins(make_data(nev=11)))
    assert st.lut_plan(st.read_bins) is plan  # the two last kept
    assert len(st._lut_plans) == 2
    batch, _ = st.evaluate_batch(theta[None].repeat(3, 1), side)
    assert batch.shape == (3, st.nsignals, 37)
