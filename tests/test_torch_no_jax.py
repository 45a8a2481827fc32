"""The port stands alone: it imports no jax and never runs silently on
the CPU when the card was asked for."""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "sxmc_tpu_torch"

# Imports every module of the package with jax and sxmc_tpu blocked,
# then asks the CLI for the card.
_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sxmc_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import sxmc_tpu_torch
for m in pkgutil.walk_packages(sxmc_tpu_torch.__path__, "sxmc_tpu_torch."):
    importlib.import_module(m.name)
assert not any(k.split(".")[0] in ("jax", "sxmc_tpu") for k in sys.modules)
assert "sxmc_tpu_torch.parallel.ensemble" in sys.modules
print("imported", len(sys.modules))

import torch
from sxmc_tpu_torch.cli import main
if torch.cuda.is_available():
    print("cuda present")
else:
    try:
        main([sys.argv[1], sys.argv[2], "--device", "cuda"])
    except RuntimeError as e:
        print("raised:", e)
    else:
        raise SystemExit("--device cuda without CUDA did not raise")
"""


def test_no_jax_import_statement_in_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|sxmc_tpu)\b(?!_torch)",
                     re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not hits, hits


def test_imports_with_jax_blocked_and_cuda_is_explicit(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cfg = REPO / "tests" / "data" / "golden" / "config.json"
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(cfg), str(tmp_path / "out")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
    if "cuda present" not in proc.stdout:
        assert "raised:" in proc.stdout and "--device cpu" in proc.stdout
        assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("flag", [["--sharded"], ["--hypotest", "10"],
                                  ["--gof"], ["--bias-study", "5"],
                                  ["--checkpoint-steps", "100"],
                                  ["--rate-substeps", "2"], ["--binned"],
                                  ["--sampler", "hmc"],
                                  ["--sharded", "--sampler", "tempered"]])
def test_out_of_slice_cli_flags_raise(tmp_path, flag):
    """--binned, --rate-substeps and --sharded run a binned, a blocked
    or a sharded fit of the golden configuration, --hypotest, --gof
    and --bias-study the frequentist tier beside its Metropolis fit,
    --checkpoint-steps a checkpointed fit (its file removed at the end)
    and --sampler hmc an HMC fit (12 steps: 17 evaluations a step);
    --sharded with --sampler tempered, which the sharded runner does not
    take, raises ValueError instead of quietly running a Metropolis
    fit."""
    from sxmc_tpu_torch.cli import main

    if flag in (["--binned"], ["--rate-substeps", "2"], ["--sharded"],
                ["--hypotest", "10"], ["--gof"], ["--bias-study", "5"],
                ["--checkpoint-steps", "100"], ["--sampler", "hmc"]):
        cfg = json.loads((REPO / "tests" / "data" / "golden" /
                          "config.json").read_text())
        cfg["fit"].update(nexperiments=1, output_format="npz",
                          nsteps=12 if "hmc" in flag else 200)
        path = tmp_path / "config.json"
        path.write_text(json.dumps(cfg))
        out = tmp_path / "out"
        golden = str(REPO / "tests" / "data" / "golden")
        assert main([str(path), str(out), "--device", "cpu",
                     "--data-root", golden] + flag) == 0
        recs = [json.loads(line) for line in
                (out / "golden_metrics.jsonl").read_text().splitlines()]
        assert "experiment_failed" not in [r["event"] for r in recs]
        limit = [r for r in recs if r["event"] == "experiment_limit"][0]
        assert np.isfinite(limit["upper"])
        tier = {"--hypotest": "golden_hypotest_0.json",
                "--bias-study": "golden_pulls.json"}
        if flag[0] in tier:
            assert (out / tier[flag[0]]).exists()
        if flag == ["--gof"]:
            assert "experiment_gof" in [r["event"] for r in recs]
        fit = [r for r in recs if r["event"] == "experiment_fit"]
        if flag[0] == "--checkpoint-steps":
            assert fit[0]["checkpoint_steps"] == 100
            assert not list(out.glob("*.ckpt.npz"))
        if flag[0] == "--sampler":
            assert fit[0]["sampler"] == "hmc"
            assert fit[0]["evaluations"] == 1 + 12 * 17
        return
    with pytest.raises(ValueError, match="tempered"):
        main(["config.json", str(tmp_path), "--device", "cpu"] + flag)


@pytest.mark.parametrize("entry", ["MCMC", "PdfStack", "EvalHist",
                                   "TemperedMCMC", "run_sharded_ensemble",
                                   "MLE", "HMC", "NUTS", "StretchSampler",
                                   "run_multihost_ensemble",
                                   "run_sharded_chain", "make_mesh",
                                   "event_sharded_nll"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """MCMC, TemperedMCMC, HMC, NUTS, StretchSampler, MLE, PdfStack,
    EvalHist, the sharded ensemble (``run_sharded_ensemble``), the
    multi-process ensemble, the event-sharded chain and NLL and the mesh
    take the card unless the caller asks for the CPU: without CUDA,
    calling one with no device raises (naming --device cpu) instead of
    quietly running on the CPU."""
    import torch

    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.mcmc.hmc import HMC
    from sxmc_tpu_torch.mcmc.metropolis import MCMC
    from sxmc_tpu_torch.mcmc.nuts import NUTS
    from sxmc_tpu_torch.mcmc.stretch import StretchSampler
    from sxmc_tpu_torch.mcmc.tempered import TemperedMCMC
    from sxmc_tpu_torch.parallel import ensemble
    from sxmc_tpu_torch.parallel import mesh as mesh_lib
    from sxmc_tpu_torch.parallel.chain_sharded import run_sharded_chain
    from sxmc_tpu_torch.parallel.multihost import run_multihost_ensemble
    from sxmc_tpu_torch.parallel.nll_sharded import event_sharded_nll
    from sxmc_tpu_torch.pdf.evalhist import EvalHist
    from sxmc_tpu_torch.pdf.stack import PdfStack
    from sxmc_tpu_torch.stats.mle import MLE
    from test_torch_pdf import make_stack_inputs

    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch", n_mc=200)

    class Built(Exception):  # the ensemble's set-up reached: its device
        pass

    def setup(fc, nsteps, device, dataset_fn):
        raise Built(device)

    def sharded():
        monkeypatch.setattr(ensemble, "_ensemble_setup", setup)
        fc = FitConfig(sources=srcs, signals=sigs, systematics=systs,
                       observables=obs, nexperiments=2, nsteps=10,
                       nchains=2)
        try:
            ensemble.run_sharded_ensemble(fc, verbose=False)
        except Built as e:
            return e.args[0]

    build = {"MCMC": lambda: MCMC(srcs, sigs, systs, obs),
             "TemperedMCMC": lambda: TemperedMCMC(srcs, sigs, systs, obs),
             "MLE": lambda: MLE(srcs, sigs, systs, obs),
             "HMC": lambda: HMC(srcs, sigs, systs, obs),
             "NUTS": lambda: NUTS(srcs, sigs, systs, obs),
             "StretchSampler": lambda: StretchSampler(srcs, sigs, systs, obs),
             "PdfStack": lambda: PdfStack(sigs, obs, systs),
             "EvalHist": lambda: EvalHist(
                 np.zeros((4, 1), np.float32), 1, 1, [0.0], [1.0], [2]),
             "run_sharded_ensemble": lambda: sharded(),
             "run_multihost_ensemble": lambda: run_multihost_ensemble(
                 FitConfig(sources=srcs, signals=sigs, systematics=systs,
                           observables=obs, nexperiments=2, nsteps=10)),
             "run_sharded_chain": lambda: run_sharded_chain(
                 MCMC(srcs, sigs, systs, obs, device="cpu"),
                 np.zeros((4, 2), np.float32), 10),
             "make_mesh": lambda: mesh_lib.make_mesh(),
             "event_sharded_nll": lambda: event_sharded_nll(
                 None, MCMC(srcs, sigs, systs, obs, device="cpu").static)}
    if torch.cuda.is_available():
        if entry in ("make_mesh", "MCMC", "PdfStack", "EvalHist",
                     "TemperedMCMC", "MLE", "HMC", "NUTS", "StretchSampler",
                     "run_sharded_ensemble"):
            got = build[entry]()
            got = got.flat()[0] if entry == "make_mesh" else got
            assert getattr(got, "device", got).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        build[entry]()
