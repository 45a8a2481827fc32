"""``run_sharded_ensemble`` against the JAX runner on every route, and
``--sharded --device cpu`` end to end (split from test_torch_sharded.py,
whose docstring states the tolerances and whose fixture and helpers
serve here)."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)
from test_torch_sharded import GOLDEN, _compare_runs, setup  # noqa: F401

torch.set_num_threads(1)


def test_run_sharded_ensemble_matches_jax(setup, monkeypatch, tmp_path):
    """The grouped diagonal route end to end against the JAX runner."""
    _compare_runs(setup, monkeypatch, tmp_path, "diagonal")


@pytest.mark.parametrize("route", ["full_cov", "rate_substeps", "fixed"])
def test_run_sharded_ensemble_routes_match_jax(setup, monkeypatch, tmp_path,
                                               route):
    """The grouped tril and blocked routes through both retunes, and the
    per-experiment route (fixed systematics), against the JAX runner."""
    _compare_runs(setup, monkeypatch, tmp_path, route)


def test_cli_sharded_on_the_cpu(tmp_path, capsys):
    from sxmc_tpu_torch.cli import main

    cfg = json.loads(open(os.path.join(GOLDEN, "config.json")).read())
    cfg["fit"].update(nsteps=100, nchains=2, output_format="npz")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    assert main([str(path), str(out), "--sharded", "--device", "cpu",
                 "--data-root", GOLDEN]) == 0
    assert "Median upper limit" in capsys.readouterr().out
    recs = [json.loads(line) for line in
            (out / "golden_metrics.jsonl").read_text().splitlines()]
    fit = [r for r in recs if r["event"] == "sharded_fit"][0]
    assert fit["route"] == "grouped" and fit["steps_per_sec"] > 0
    limits = [r["upper"] for r in recs if r["event"] == "experiment_limit"]
    assert len(limits) == 2 and np.isfinite(limits).all()
    for i in range(2):
        assert (out / f"golden_{i}.npz").exists()
