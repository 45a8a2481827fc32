"""Every checkpoint runner of sxmc_tpu_torch.checkpoint, killed after a
few segments and resumed from its file, keeps exactly the samples and
NLLs of the uninterrupted checkpointed run: Metropolis diagonal,
full_cov, blocked; tempered; HMC; NUTS; stretch (the JAX gates
``test_aux::test_resume_reproduces_uninterrupted_run``,
``test_tempered::test_checkpoint_kill_and_resume`` and
``test_fullcov::test_checkpoint_full_cov_resume``, here bit for bit).
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch import checkpoint
from sxmc_tpu_torch.mcmc.hmc import HMC
from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.mcmc.nuts import NUTS
from sxmc_tpu_torch.mcmc.stretch import StretchSampler

from test_torch_checkpoint import inputs, tempered
from test_torch_hmc import GEN
from test_torch_pdf import make_data
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


class Killed(Exception):
    pass


def kill_after(monkeypatch, nsaves: int, exc=Killed):
    """Make the runner stop right after its ``nsaves``-th state write, as
    a preempted fit would."""
    orig = checkpoint.save_chain_state
    calls = {"n": 0}

    def save(path, state):
        orig(path, state)
        calls["n"] += 1
        if calls["n"] == nsaves:
            raise exc()

    monkeypatch.setattr(checkpoint, "save_chain_state", save)
    return lambda: monkeypatch.setattr(checkpoint, "save_chain_state", orig)


RUNNERS = {
    "diagonal": (lambda: MCMC(*inputs(), device="cpu"),
                 checkpoint.run_checkpointed, {}),
    "full_cov": (lambda: MCMC(*inputs(), device="cpu"),
                 checkpoint.run_checkpointed, {"proposal": "full_cov"}),
    "blocked": (lambda: MCMC(*inputs(), device="cpu"),
                checkpoint.run_checkpointed, {"rate_substeps": GEN.CKPT_M}),
    "tempered": (tempered, checkpoint.run_checkpointed_tempered, {}),
    "hmc": (lambda: HMC(*inputs(), device="cpu"),
            checkpoint.run_checkpointed_hmc, {}),
    "nuts": (lambda: NUTS(*inputs(), device="cpu"),
             checkpoint.run_checkpointed_hmc, {}),
    "stretch": (lambda: StretchSampler(*inputs(), device="cpu"),
                checkpoint.run_checkpointed_stretch, {}),
}


@pytest.mark.parametrize("tag", list(RUNNERS))
def test_kill_and_resume_bit_for_bit(tmp_path, monkeypatch, tag):
    make, runner, kw = RUNNERS[tag]
    gradient = tag in ("hmc", "nuts")
    nsteps = 20 if gradient else GEN.CKPT_STEPS
    data = make_data(nev=GEN.NEV)

    def run(path):
        return runner(make(), data, nsteps, 0.2 if not gradient else 0.5,
                      segment_steps=3 if gradient else GEN.CKPT_SEG,
                      checkpoint_path=str(path), seed=7, **kw)

    full = run(tmp_path / "full.npz")
    path = tmp_path / "killed.npz"
    restore = kill_after(monkeypatch, 3)
    with pytest.raises(Killed):
        run(path)
    restore()
    st = checkpoint.load_chain_state(str(path))
    assert 0 < int(st["step"]) < nsteps and int(st["segment"]) == 3
    resumed = run(path)
    np.testing.assert_array_equal(resumed.samples, full.samples)
    np.testing.assert_array_equal(resumed.nll_values, full.nll_values)
    assert np.isfinite(full.samples).all() and len(full.samples) > 0
