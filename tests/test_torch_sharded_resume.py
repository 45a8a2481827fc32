"""The sharded ensemble's segment checkpoints (a killed run resumes bit
for bit) and its launches of whole experiments (split from
test_torch_sharded.py, whose fixture and helpers serve here)."""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.ops import kernels
from sxmc_tpu_torch.parallel import ensemble as tpe

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)
from test_torch_sharded import (CPE, NEXP, NSTEPS, _fit_config,  # noqa: F401
                                setup)

torch.set_num_threads(1)


@pytest.mark.parametrize("fit", [{}, {"proposal": "full_cov"},
                                 {"rate_substeps": 2}, {"binned": True}])
def test_kill_and_resume_is_bitwise(setup, tmp_path, monkeypatch, fit):
    """A run killed after its third segment and resumed equals the
    uninterrupted run bit for bit: grouped diagonal, tril and blocked,
    and the per-experiment (binned) route."""
    fc = _fit_config("sxmc_tpu_torch", nsteps=60, **fit)
    kw = dict(device="cpu", verbose=False, checkpoint_steps=NSTEPS,
              dataset_fn=lambda i: setup["datasets"][i])
    ls_a, lim_a = tpe.run_sharded_ensemble(
        fc, checkpoint_path=str(tmp_path / "a"), **kw)
    real, calls = tpe._segment, []

    def dying(*args, **kwargs):
        if len(calls) >= 3:
            raise RuntimeError("simulated preemption")
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tpe, "_segment", dying)
    with pytest.raises(RuntimeError, match="preemption"):
        tpe.run_sharded_ensemble(fc, checkpoint_path=str(tmp_path / "b"),
                                 **kw)
    monkeypatch.setattr(tpe, "_segment", real)
    state = dict(np.load(str(tmp_path / "b") + ".state.npz"))
    assert state["params"].shape == (NEXP, CPE, 3) and state["phase"] == 1
    ls_b, lim_b = tpe.run_sharded_ensemble(
        fc, checkpoint_path=str(tmp_path / "b"), resume=True, **kw)
    assert lim_a == lim_b and np.isfinite(lim_a).all()
    for a, b in zip(ls_a, ls_b):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.nll_values, b.nll_values)


def test_grouped_batch_splits_into_launches(setup):
    """Past one launch's chain caps the batch goes out in launches of
    whole experiments; one experiment's chains alone must fit."""
    ns = setup[False][1].nll_spec  # 3 parameters, 2 signals
    assert kernels._experiment_groups(ns, 4, 8) == [(0, 4)]
    assert kernels._experiment_groups(ns, 5, 8) == [(0, 4), (4, 5)]
    assert kernels._experiment_groups(ns, 100, 1) == [(0, 32), (32, 64),
                                                       (64, 96), (96, 100)]
    with pytest.raises(ValueError, match="exceed one launch"):
        kernels._experiment_groups(ns, 1, 33)
