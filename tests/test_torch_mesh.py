"""sxmc_tpu_torch.parallel.mesh against the JAX package's meshes.

The shapes (or ValueError) of ``make_mesh``, ``auto_mesh`` and
``local_mesh`` on 1, 2, 4 and 8 devices and the blocks of
``process_local_experiments`` are the ones the JAX package gave on its
8 virtual CPU devices (stored by
``tests/data/parallel_reference/make_reference.py``); the port's devices
here are ``[torch.device("cpu")] * n`` (a device may repeat).  The
collective adds in shard order.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)

REF_DIR = (pathlib.Path(__file__).resolve().parent / "data" /
           "parallel_reference")


def load_reference():
    """(the generator module with the inputs' constants, its answers)."""
    spec = importlib.util.spec_from_file_location(
        "parallel_make_reference", REF_DIR / "make_reference.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen, dict(np.load(REF_DIR / "reference.npz"))


GEN, REF = load_reference()
CPU = torch.device("cpu")


def shape_or(make, ndim):
    try:
        return list(make().devices.shape)
    except ValueError:
        return [-1] * ndim


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_make_and_auto_mesh_match_jax(nd):
    devs = [CPU] * nd
    got = [shape_or(lambda: mesh_lib.make_mesh(*s, devices=devs), 3)
           for s in GEN.MESH_SHAPES]
    np.testing.assert_array_equal(got, REF[f"mesh_make_{nd}"])
    got = [shape_or(lambda: mesh_lib.auto_mesh(*a, devices=devs), 3)
           for a in GEN.AUTO]
    np.testing.assert_array_equal(got, REF[f"mesh_auto_{nd}"])
    m = mesh_lib.make_mesh(exp=nd, devices=devs)
    assert m.shape == {"exp": nd, "chain": 1, "event": 1}
    assert m.axis_names == ("exp", "chain", "event") and m.size == nd
    with pytest.raises(ValueError, match=f"needs {2 * nd} devices"):
        mesh_lib.make_mesh(exp=2 * nd, devices=devs)


def test_local_mesh_and_process_blocks_match_jax():
    got = [shape_or(lambda: mesh_lib.local_mesh(c, devices=[CPU] * 8), 2)
           for c in GEN.LOCAL_CHAINS]
    np.testing.assert_array_equal(got, REF["mesh_local_8"])
    for n, pc in GEN.PLE:
        for pi in range(pc):
            assert mesh_lib.process_local_experiments(n, pi, pc) == \
                REF[f"mesh_ple_{n}_{pi}_{pc}"].tolist()
    # No process group: one process owns everything.
    assert mesh_lib.process_index_count() == (0, 1)
    assert mesh_lib.process_local_experiments(5) == [0, 1, 2, 3, 4]
    assert not mesh_lib.initialize_distributed(num_processes=1)


def test_shard_sum_adds_in_shard_order():
    """float32 parts whose sum depends on the order: the collective
    gives the left-to-right sum in shard order, on the first device."""
    parts = [torch.tensor([1e8], dtype=torch.float32),
             torch.tensor([1.0], dtype=torch.float32),
             torch.tensor([-1e8], dtype=torch.float32),
             torch.tensor([1.0], dtype=torch.float32)]
    got = mesh_lib.shard_sum(parts, CPU)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(got, want) and float(got) == 1.0
    assert float(mesh_lib.shard_sum(parts[::-1])) == 0.0  # another order
    assert mesh_lib.blocks(7, 3) == [(0, 3), (3, 5), (5, 7)]
    m = mesh_lib.Mesh(np.asarray([CPU] * 4, dtype=object).reshape(2, 2),
                      ("exp", "chain"))
    assert m.shape == {"exp": 2, "chain": 2} and m.flat() == [CPU] * 4
