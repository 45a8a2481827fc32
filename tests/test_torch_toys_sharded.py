"""sxmc_tpu_torch.parallel.toys_sharded, and ``mesh=`` of the
Feldman-Cousins belt and the pull study, on CPU meshes.

The toy batch split over the mesh's shards gives exactly the unsharded
batch's results (a BFGS row is frozen once it finishes, so it does not
depend on the rows beside it), and the JAX package's sharded answers
(its 8 virtual devices; ``tests/data/parallel_reference/``) on the same
toys within test_torch_hypotest.py's and test_torch_gof.py's
tolerances: dNLL 2e-3 absolute, r-hat 1e-3 relative, pull errors 1e-3
relative.
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.toys_sharded import (_pad_to_devices,
                                                  sharded_pull_batch,
                                                  sharded_toy_dnll)
from sxmc_tpu_torch.stats.bias import pull_study, toy_fit_batch
from sxmc_tpu_torch.stats.feldman_cousins import (FeldmanCousins,
                                                  toy_dnll_batch)
from sxmc_tpu_torch.stats.mle import MLE

from test_torch_mesh import GEN, REF

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def model():
    srcs, sigs, obs = GEN.toy_model("sxmc_tpu_torch")
    mle = MLE(srcs, sigs, [], obs, device="cpu")
    rb = mle.stack.compute_read_bins(REF["toys_batch"])
    return mle, rb


def test_pad_to_devices():
    a = torch.arange(10).reshape(5, 2)
    p, n = _pad_to_devices(a, 8)
    assert p.shape == (8, 2) and n == 5
    assert torch.equal(p[5:], a[:1].expand(3, 2))
    p2, n2 = _pad_to_devices(a, 5)
    assert p2.shape == (5, 2) and n2 == 5


def test_sharded_toy_dnll(model):
    mle, rb = model
    rv = np.full(rb.shape[0], GEN.TOY_R, np.float32)
    free = tuple(mle._free_rates)
    d_un, r_un = toy_dnll_batch(mle, rv, rb, 0, free)
    for mesh in (mesh_lib.make_mesh(exp=8, devices=CPU8),
                 mesh_lib.make_mesh(exp=5, devices=CPU8)):  # pad rows
        d_sh, r_sh = sharded_toy_dnll(mesh, mle, rv, rb, 0, free)
        np.testing.assert_array_equal(d_sh, d_un)
        np.testing.assert_array_equal(r_sh, r_un)
    np.testing.assert_allclose(d_sh, REF["toys_dnll"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(r_sh, REF["toys_rhat"], rtol=1e-3)


def test_sharded_pulls(model):
    mle, rb = model
    free = tuple(mle._free_rates)
    r_un, e_un = toy_fit_batch(mle, rb, free)
    mesh = mesh_lib.make_mesh(exp=8, devices=CPU8)
    r_sh, e_sh = sharded_pull_batch(mesh, mle, rb, free)
    np.testing.assert_array_equal(r_sh, r_un)
    np.testing.assert_array_equal(e_sh, e_un)
    np.testing.assert_allclose(r_sh, REF["toys_pull_r"], rtol=1e-3)
    np.testing.assert_allclose(e_sh, REF["toys_pull_err"], rtol=1e-3)


def test_belt_via_mesh(model):
    """FeldmanCousins.build_belt(mesh=...) on a 4 x 2 mesh: the belt of
    the unsharded batch on the same toys."""
    mle, _ = model
    fc = FeldmanCousins(mle, "sig")
    belts = [fc.build_belt(torch.Generator().manual_seed(5), [0.5, 1.0],
                           ntoys=12, cl=0.9, mesh=mesh)
             for mesh in (None, mesh_lib.make_mesh(exp=4, chain=2,
                                                   devices=CPU8))]
    assert belts[1].dnll_toys.shape == (2, 12)
    assert np.all(belts[1].crit >= 0)
    np.testing.assert_array_equal(belts[1].dnll_toys, belts[0].dnll_toys)
    np.testing.assert_array_equal(belts[1].crit, belts[0].crit)


def test_pull_study_mesh_kwarg(model):
    mle, _ = model
    studies = [pull_study(mle, 20, torch.Generator().manual_seed(7),
                          mesh=mesh)
               for mesh in (None, mesh_lib.make_mesh(exp=8, devices=CPU8))]
    assert studies[1].estimates.shape == (20, 2)
    assert all(v["n_used"] > 0 for v in studies[1].summary().values())
    np.testing.assert_array_equal(studies[1].estimates, studies[0].estimates)
    np.testing.assert_array_equal(studies[1].errors, studies[0].errors)
