"""Kernel B2 on the card: both forms (the staged table and the L1 form)
at the four shapes of PERF.md's table and at rows past the shared-memory
budget, held bit for bit to ``lut_eval_plain`` on the same inputs (NaN
and 0 sentinels in place), with the launch counter, the caller's
stream, ragged and misaligned read-bin rows and a staged table above
48 KB.  These need an NVIDIA Hopper card and skip elsewhere; run them
there with ``python -m pytest --noconftest -m cuda
tests/test_torch_lut_cuda.py``.  No JAX here.
"""

import pytest
import torch

from sxmc_tpu_torch.ops import kernels

torch.set_num_threads(1)

# (nseg, rows, nev, total): the example (2 x 1,464 x 10), 8 chains x 2
# signals on its 2 read-bin rows, 2 x 1M x 1,000 and 16 rows on 2 at
# that size.
SHAPES = [(2, 2, 1464, 10), (16, 2, 1464, 10), (2, 2, 1_000_000, 1000),
          (16, 2, 1_000_000, 1000)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _inputs(dev, nseg, rows, nev, total, seed=1):
    gen = torch.Generator(dev).manual_seed(seed)
    counts = torch.randint(0, 5000, (nseg, total), generator=gen,
                           device=dev).to(torch.float32)
    norms = counts.sum(dim=1)
    rb = torch.randint(-2, total, (rows, nev), generator=gen, device=dev,
                       dtype=torch.int32)
    return counts, norms, rb


def _same(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 0])
def test_cuda_lut_forms_equal_plain(dev, budget):
    """The staged form (budget None: the card's) and the L1 form (budget
    0) at every shape, each with its loads (one or four int4s a thread a
    tile, by the row's events); and at rows of 60,000 bins, past the
    budget, the L1 form by shape."""
    for nseg, rows, nev, total in SHAPES + [(16, 2, 1464, 60_000)]:
        counts, norms, rb = _inputs(dev, nseg, rows, nev, total)
        plan = kernels.LutPlan(rb, 0.01, budget=budget)
        got = plan(counts, norms)
        _same(got, kernels.lut_eval_plain(counts, norms, rb, 0.01))
        form = plan.form(nseg, total)
        assert form["staged"] == (budget is None and total < 50_000)
        assert form["vecs"] == (4 if nev >= kernels.LUT_WIDE_EVENTS else 1)


@pytest.mark.cuda
def test_cuda_lut_counts_one_launch_a_call(dev):
    counts, norms, rb = _inputs(dev, *SHAPES[1])
    plan = kernels.LutPlan(rb, 0.01)
    kernels.reset_launch_counts()
    for _ in range(3):
        plan(counts, norms)
    kernels.lut_eval(counts, norms, rb, 0.01)
    assert kernels.launch_counts()["lut_eval"] == 4
    empty = kernels.LutPlan(rb[:, :0].contiguous(), 0.01)(counts, norms)
    assert empty.shape == (16, 0)
    assert kernels.launch_counts()["lut_eval"] == 4


@pytest.mark.cuda
def test_cuda_lut_on_the_current_stream(dev):
    counts, norms, rb = _inputs(dev, *SHAPES[3])
    plan = kernels.LutPlan(rb, 0.01)
    want = kernels.lut_eval_plain(counts, norms, rb, 0.01)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = plan(counts, norms)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.cuda
def test_cuda_lut_ragged_and_misaligned(dev):
    """nev % 4 != 0 (rows of every 16-byte phase) and read bins that
    start past an allocation's boundary (a row of a larger tensor), with
    8, 3 and 33 table rows on each read-bin row, both loads (a row past
    LUT_WIDE_EVENTS), and more table rows than a grid's y (65,535)."""
    for k, rows, nev, off in ((8, 2, 1001, 0), (3, 3, 4099, 1),
                              (33, 1, 10_007, 3), (8, 2, 5, 2),
                              (2, 2, 70_001, 1), (33_000, 2, 9, 1)):
        counts, norms, big = _inputs(dev, k * rows, rows + 1, nev + off, 37)
        rb = big.reshape(-1)[off:off + rows * nev].reshape(rows, nev)
        for budget in (None, 0):
            got = kernels.LutPlan(rb, 0.3, budget=budget)(counts, norms)
            _same(got, kernels.lut_eval_plain(counts, norms, rb, 0.3))


@pytest.mark.cuda
def test_cuda_lut_staged_above_48k(dev):
    """One row's table of 20,000 bins (80 KB): staged with the opt-in,
    then a smaller opt-in table, then the first again; the output is
    contiguous."""
    for total in (20_000, 14_000, 20_000):
        counts, norms, rb = _inputs(dev, 4, 2, 3000, total)
        plan = kernels.LutPlan(rb, 0.01)
        got = plan(counts, norms)
        assert plan.form(4, total)["staged"] and got.is_contiguous()
        _same(got, kernels.lut_eval_plain(counts, norms, rb, 0.01))
