"""The tier's CLI options (--sampler mle --gof, --hypotest,
--bias-study) on the CPU against the JAX package's stored answers
(split from test_torch_gof.py, whose docstring states the
tolerances)."""

import json

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.fitconfig import FitConfig

from test_torch_mle import GEN, REF_DIR
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


def cli_run(tmp_path, tag, **kw):
    """The port's ensemble on the golden configuration fed the JAX run's
    fake dataset; returns (port outputs, JAX outputs)."""
    from sxmc_tpu_torch.ensemble import run_ensemble

    ref = json.loads((REF_DIR / f"cli_{tag}.json").read_text())
    golden = REF_DIR.parent / "golden"
    cfg = json.loads((golden / "config.json").read_text())
    cfg["fit"].update(nexperiments=1, nsteps=GEN.CLI_STEPS,
                      output_format="npz")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    fc = FitConfig.from_json_file(str(path), data_root=str(golden))
    out = tmp_path / "out"
    data = np.asarray(ref["dataset"], np.float32)
    limits = run_ensemble(fc, str(out), device="cpu", verbose=False,
                          max_retries=0, dataset_fn=lambda i: data, **kw)
    got = {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}
    assert len(limits) == 1 and np.isfinite(limits[0])
    return got, ref


def test_cli_mle_gof_asymptotic_matches_jax(tmp_path):
    got, ref = cli_run(tmp_path, "mle", sampler="mle", gof_toys=0,
                       hypotest_asymptotic=True)
    mle, want = got["golden_mle_0.json"], ref["golden_mle_0.json"]
    assert mle["upper_limit"] == pytest.approx(want["upper_limit"], rel=1e-3)
    assert abs(mle["nll"] - want["nll"]) <= 1e-3
    assert mle["converged"] == want["converged"]
    for name in ("signal1", "signal2"):
        assert mle["params"][name] == pytest.approx(want["params"][name],
                                                    rel=1e-3)
    ht, want = got["golden_hypotest_0.json"], ref["golden_hypotest_0.json"]
    for key in ("profile_limit", "asymptotic_limit"):
        assert ht[key] == pytest.approx(want[key], rel=1e-3)
    for n, v in want["asymptotic_expected"].items():
        assert ht["asymptotic_expected"][n] == pytest.approx(v, rel=1e-3)
    assert abs(ht["q0"] - want["q0"]) <= 2e-3


def test_cli_hypotest_bias_matches_jax(tmp_path):
    """Beside the Metropolis fit, with toys of the port's own RNG: the
    deterministic outputs match, the toy ones are finite."""
    got, ref = cli_run(tmp_path, "metropolis", hypotest_toys=8,
                       bias_toys=8)
    ht, want = got["golden_hypotest_0.json"], ref["golden_hypotest_0.json"]
    assert ht["profile_limit"] == pytest.approx(want["profile_limit"],
                                                rel=1e-3)
    assert abs(ht["q0"] - want["q0"]) <= 2e-3
    # The coarse grid (from the profile limit) is in both; the
    # refinement points depend on the toys.
    hi = max(2.0 * want["profile_limit"], 1e-2)
    for r in np.linspace(hi / 8.0, hi, 8):
        assert np.min(np.abs(np.asarray(ht["r_grid"]) - r)) <= 1e-3 * r
    assert np.isfinite(ht["cls_limit"]) and ht["ntoys"] == 8
    pulls, want = got["golden_pulls.json"], ref["golden_pulls.json"]
    assert (pulls["ntoys"], pulls["cl"]) == (want["ntoys"], want["cl"])
    assert sorted(pulls["summary"]) == sorted(want["summary"])
    for s in pulls["summary"].values():
        assert s["n_used"] == 8 and np.isfinite(s["pull_mean"])
