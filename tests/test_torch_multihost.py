"""The multi-process ensemble (``parallel.multihost``, ``--num-processes``)
and the sharded ensemble over a mesh, on the CPU.

Two gloo processes (``init_method=file://``, or the CLI's
``--coordinator 127.0.0.1:<free port>``) each fit their half of the
experiments; their gathered limits equal one process's bit for bit (the
datasets and streams are keyed by the global experiment, every block is
padded to the ensemble's longest dataset).  The sharded ensemble split
over a CPU mesh's ``{exp, chain}`` blocks equals the one-device batch bit
for bit.  The children of a test share one deadline.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.parallel import ensemble as ens
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.multihost import run_multihost_ensemble

from torch_multihost_worker import fit_config

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
WORKER = HERE / "torch_multihost_worker.py"
# Seconds both children of one test may take together, several times
# their ~8 s in a loaded Tier-1 run.
TIMEOUT = 120


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(HERE), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")


def _run_all(cmds, cwd):
    procs = [subprocess.Popen(c, env=_env(), cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)  # a killed child is reaped at once
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def one_process():
    _, limits = run_multihost_ensemble(fit_config(), device="cpu",
                                       verbose=False)
    return limits


def test_two_processes_match_one(tmp_path, one_process):
    assert np.all(one_process > 0) and one_process.shape == (4,)
    init = f"file://{tmp_path / 'rendezvous'}"
    _run_all([[sys.executable, str(WORKER), str(pid), "2", init,
               str(tmp_path)] for pid in (0, 1)], str(tmp_path))
    r = [json.loads((tmp_path / f"limits_{pid}.json").read_text())
         for pid in (0, 1)]
    assert r[0]["nproc"] == r[1]["nproc"] == 2
    assert r[0]["local"] == [0, 1] and r[1]["local"] == [2, 3]
    assert r[0]["limits"] == r[1]["limits"] == one_process.tolist()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_two_processes(tmp_path):
    """``python -m sxmc_tpu_torch.cli ... --num-processes 2 --coordinator
    127.0.0.1:<port> --process-id i`` on the golden configuration (4
    experiments, 200 steps): each process writes its experiments' outputs
    and a multihost_fit record; the limits equal one process's."""
    from sxmc_tpu_torch.fitconfig import FitConfig

    golden = REPO / "tests" / "data" / "golden"
    cfg = json.loads((golden / "config.json").read_text())
    cfg["fit"].update(nexperiments=4, nsteps=200, output_format="npz",
                      plots=False)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_all([[sys.executable, "-m", "sxmc_tpu_torch.cli", str(path),
                      str(out), "--device", "cpu", "--data-root",
                      str(golden), "--num-processes", "2", "--coordinator",
                      coord, "--process-id", str(pid)] for pid in (0, 1)],
                    str(tmp_path))
    assert "Upper limits:" in outs[0]
    recs = [json.loads((out / f"golden_metrics_{pid}.jsonl").read_text())
            for pid in (0, 1)]
    assert recs[0]["experiments"] == [0, 1] and recs[1]["experiments"] == \
        [2, 3]
    assert sorted(p.name for p in out.glob("golden_*.npz")) == \
        [f"golden_{i}.npz" for i in range(4)]
    fc = FitConfig.from_json_file(str(path), data_root=str(golden))
    _, want = run_multihost_ensemble(fc, device="cpu", verbose=False)
    assert recs[0]["limits"] == recs[1]["limits"] == want.tolist()


@pytest.mark.parametrize("shape", [{"exp": 2}, {"exp": 4, "chain": 2}])
def test_sharded_ensemble_over_a_mesh(shape, one_process):
    """run_sharded_ensemble(mesh=...) equals the one-device batch, which
    equals one process of the multi-process ensemble."""
    fc = fit_config()
    ls0, lim0 = ens.run_sharded_ensemble(fc, device="cpu", verbose=False)
    assert lim0 == one_process.tolist()
    mesh = mesh_lib.make_mesh(devices=[torch.device("cpu")] * 8, **shape)
    ls1, lim1 = ens.run_sharded_ensemble(fc, device="cpu", verbose=False,
                                         mesh=mesh)
    assert lim1 == lim0
    for a, b in zip(ls0, ls1):
        np.testing.assert_array_equal(a.nll_values, b.nll_values)
