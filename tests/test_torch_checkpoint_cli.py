"""``--checkpoint-steps`` through the port's CLI: a killed fit resumes
from the file it left, and ``--sharded`` hands its checkpoints to the
sharded runner."""

import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)
from test_torch_resume import kill_after

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_ensemble_resumes_a_killed_experiment(tmp_path, monkeypatch):
    """Through the CLI's --checkpoint-steps: a killed fit leaves its
    ``{prefix}_chain_{i}.ckpt.npz``, the rerun resumes it and removes it,
    and the result is the uninterrupted run's."""
    from sxmc_tpu_torch.cli import main

    golden = REPO / "tests" / "data" / "golden"
    cfg = json.loads((golden / "config.json").read_text())
    cfg["fit"].update(nexperiments=1, nsteps=60, output_format="npz")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    argv = ["--device", "cpu", "--data-root", str(golden),
            "--checkpoint-steps", "8", "--max-retries", "0"]
    assert main([str(path), str(tmp_path / "a")] + argv) == 0

    class Stop(KeyboardInterrupt):  # passes the ensemble's fault barrier
        pass

    restore = kill_after(monkeypatch, 2, Stop)
    with pytest.raises(Stop):
        main([str(path), str(tmp_path / "b")] + argv)
    restore()
    left = tmp_path / "b" / "golden_chain_0.ckpt.npz"
    assert left.exists()
    assert main([str(path), str(tmp_path / "b")] + argv) == 0
    assert not left.exists()
    a = np.load(tmp_path / "a" / "golden_0.npz")
    b = np.load(tmp_path / "b" / "golden_0.npz")
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])



def test_sharded_cli_checkpoints(tmp_path):
    """``--sharded --checkpoint-steps N`` hands the batch's checkpoints to
    the sharded runner under ``<out>/<prefix>_sharded`` and removes them
    once the fit completes."""
    from sxmc_tpu_torch.cli import main

    golden = REPO / "tests" / "data" / "golden"
    cfg = json.loads((golden / "config.json").read_text())
    cfg["fit"].update(nexperiments=2, nchains=2, nsteps=100,
                      output_format="npz")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    assert main([str(path), str(out), "--device", "cpu", "--data-root",
                 str(golden), "--sharded", "--checkpoint-steps", "15"]) == 0
    recs = [json.loads(line) for line in
            (out / "golden_metrics.jsonl").read_text().splitlines()]
    assert [r["event"] for r in recs].count("experiment_limit") == 2
    assert sorted(p.name for p in out.iterdir()) == [
        "golden_0.npz", "golden_1.npz", "golden_metrics.jsonl"]
