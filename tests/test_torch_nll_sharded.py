"""The event-sharded NLL and the bin-sharded build and eval of
sxmc_tpu_torch.parallel against the JAX package's answers on its 8
virtual CPU devices (``tests/data/parallel_reference/``) and against the
port's unsharded stack, on 8 CPU shards.

Tolerances: the NLL within 1e-4 absolute of the JAX package's (NLLs of
about 1e3; the barrier exactly float32(1e18)) and equal to the port's
unsharded NLL but for the order of its float64 event sum; counts and
norms exact (weighted: float64 sums rounded once, rtol 1e-6 against the
JAX package's); LUT values equal to the unsharded B2 plain version, NaN
sentinels in place, and within 1e-6 relative of the JAX package's.
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.ops.nll import nll, signal_weights
from sxmc_tpu_torch.parallel import bin_sharded, nll_sharded
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.pdf.stack import PdfStack

from test_torch_mesh import GEN, REF
from test_torch_pdf import make_data, make_stack_inputs

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def model():
    mcmc = MCMC(*make_stack_inputs("sxmc_tpu_torch"), device="cpu")
    rb = mcmc.stack.compute_read_bins(make_data(nev=GEN.NLL_NEV))
    return mcmc, rb


def _exact_nll(mcmc, theta, lut, norms) -> float:
    """The NLL of ``lut`` and ``norms`` at ``theta`` with every sum and
    log in float64: the value both packages round."""
    c = mcmc.nll_spec.consts
    w = signal_weights(theta, norms, c).double()
    s = (w[:, None] * torch.nan_to_num(lut).double()).sum(0)
    ev = torch.where(s > 0, torch.log(torch.where(s > 0, s, 1.0)), 0.0).sum()
    z = ((theta - c.means) / c.sig_safe).double()
    return float(-ev + w.sum() + 0.5 * torch.where(c.sig_on, z * z,
                                                   0.0).sum())


def test_event_sharded_nll_matches_jax(model):
    """Within 1e-4 absolute of the exact NLL and of the port's unsharded
    one; within the JAX package's own bar for its sharded NLL (rtol 1e-5
    of its unsharded, tests/test_sharding.py) of the JAX answers, whose
    float32 event sums lie up to 3.7e-4 from the exact value here."""
    mcmc, rb = model
    mesh = mesh_lib.make_mesh(event=8, devices=CPU8)
    f = nll_sharded.event_sharded_nll(mesh, mcmc.static)
    for p, want in zip(GEN.NLL_POINTS, REF["nll_values"]):
        theta = torch.as_tensor(p)
        lut, norms = mcmc.stack.evaluate(theta[mcmc.nsources:], rb)
        shards = nll_sharded.shard_lut(mesh, lut)
        assert [s.shape[1] for s in shards] == [125] * 8
        got = float(f(theta, shards, norms))
        if want == np.float32(1e18):
            assert got == want  # the barrier
            continue
        assert 500 < abs(got) < 5000  # NLLs of about 1e3
        assert abs(got - _exact_nll(mcmc, theta, lut, norms)) <= 1e-4
        unsharded = float(nll(theta, lut, norms, mcmc.nll_spec.consts))
        assert abs(got - unsharded) <= 1e-4
        np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=0)


def _bin_stack(weighted=False):
    return PdfStack(*GEN.bin_fixture("sxmc_tpu_torch", weighted=weighted),
                    device="cpu")


def test_bin_sharded_build_matches_jax_and_unsharded():
    stack = _bin_stack()
    mesh = bin_sharded.make_bin_mesh(devices=CPU8)
    assert bin_sharded.padded_bins(stack.total_nbins, mesh) == 40
    for k, tv in enumerate(GEN.BIN_THETAS):
        theta = torch.tensor([tv], dtype=torch.float32)
        shards, norms = bin_sharded.bin_sharded_histograms(mesh, stack,
                                                           theta)
        h = torch.cat(shards, dim=1)
        assert h.shape == (2, 40)
        want, want_norms = stack.histograms(theta)
        assert torch.equal(h[:, :stack.total_nbins], want)
        assert torch.equal(norms, want_norms)
        assert not h[:, stack.total_nbins:].any()  # pad bins hold nothing
        np.testing.assert_array_equal(h.numpy(), REF[f"bin_hists_{k}"])
        np.testing.assert_array_equal(norms.numpy(), REF[f"bin_norms_{k}"])


def test_weighted_bin_sharded_build():
    stack = _bin_stack(weighted=True)
    mesh = bin_sharded.make_bin_mesh(devices=CPU8)
    theta = torch.tensor([GEN.BIN_WEIGHTED_THETA], dtype=torch.float32)
    shards, norms = bin_sharded.bin_sharded_histograms(mesh, stack, theta)
    h = torch.cat(shards, dim=1)
    want, want_norms = stack.histograms(theta)
    assert torch.equal(h[:, :stack.total_nbins], want)
    torch.testing.assert_close(norms, want_norms, rtol=1e-6, atol=0)
    np.testing.assert_allclose(h.numpy(), REF["bin_w_hists"], rtol=1e-6)
    np.testing.assert_allclose(norms.numpy(), REF["bin_w_norms"], rtol=1e-6)


def test_bin_sharded_eval_with_sentinels():
    stack = _bin_stack()
    stack.set_data(GEN.bin_eval_data())
    mesh = bin_sharded.make_bin_mesh(devices=CPU8)
    theta = torch.tensor([GEN.BIN_EVAL_THETA], dtype=torch.float32)
    shards, norms = bin_sharded.bin_sharded_histograms(mesh, stack, theta)
    lut = bin_sharded.bin_sharded_eval(mesh, shards, norms, stack.read_bins,
                                       stack.bin_volume)
    want, _ = stack.evaluate(theta)
    assert torch.equal(torch.isnan(lut), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(lut), torch.nan_to_num(want))
    # Both sentinels really occur in this dataset.
    assert bool(torch.isnan(lut).any()) and bool((lut == 0).any())
    np.testing.assert_allclose(lut.numpy(), REF["bin_lut"], rtol=1e-6,
                               equal_nan=True)
