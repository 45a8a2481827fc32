"""sxmc_tpu_torch.checkpoint against the JAX package's runners.

``run_checkpointed`` (diagonal, full_cov, blocked) and
``run_checkpointed_tempered`` fed the JAX package's segment streams
(stored by ``tests/data/sampler_reference/make_reference.py``, with the
JAX runs' kept samples) keep the samples and NLLs of the JAX runners:
parameters within 1e-5 relative, NLLs within 1e-3 absolute (the fused
route's float64 sums against the compensated float32 pairs; decisions
are identical but within rounding of a tie).  A checkpointed HMC fed the
same draws as the uninterrupted sampler keeps its chain exactly, and a
state file of another seed is not resumed.  Kill-and-resume of every
runner: ``test_torch_resume.py``; through the CLI:
``test_torch_checkpoint_cli.py``.
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch import checkpoint, interop
from sxmc_tpu_torch.mcmc.hmc import HMC
from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.mcmc.tempered import TemperedMCMC

from test_torch_hmc import GEN, REF, jax_draws
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

METROPOLIS = {"diagonal": {}, "full_cov": {"proposal": "full_cov"},
              "blocked": {"rate_substeps": GEN.CKPT_M}}


def inputs():
    return make_stack_inputs("sxmc_tpu_torch", n_mc=GEN.N_MC)


def tempered():
    return TemperedMCMC(*inputs(), ntemps=GEN.NTEMPS, tmax=GEN.TMAX,
                        swap_every=GEN.SWAP_EVERY, device="cpu")


def nsegments():
    return len(GEN.segment_lengths(GEN.CKPT_STEPS, GEN.CKPT_BF,
                                   GEN.CKPT_SEG))


@pytest.mark.parametrize("tag", list(METROPOLIS))
def test_run_checkpointed_fed_jax_streams_matches_jax(tmp_path, tag):
    segs = [interop.stream(REF[f"ckpt_{tag}_noise_s{i}"],
                           REF[f"ckpt_{tag}_u_s{i}"])
            for i in range(nsegments())]
    mcmc = MCMC(*inputs(), device="cpu")
    ls = checkpoint.run_checkpointed(
        mcmc, make_data(nev=GEN.NEV), GEN.CKPT_STEPS, GEN.CKPT_BF,
        segment_steps=GEN.CKPT_SEG, checkpoint_path=str(tmp_path / "c.npz"),
        stream_fn=interop.segment_draws(segs), **METROPOLIS[tag])
    np.testing.assert_allclose(ls.samples, REF[f"ckpt_{tag}_samples"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ls.nll_values, REF[f"ckpt_{tag}_nll"],
                               atol=1e-3)
    assert 0.0 < mcmc.last_accept_rate < 1.0


def test_run_checkpointed_tempered_fed_jax_streams_matches_jax(tmp_path):
    segs = [tuple(REF[f"ckpt_tempered_{k}_s{i}"]
                  for k in ("noise", "u", "swap_u"))
            for i in range(nsegments())]
    tmc = tempered()
    ls = checkpoint.run_checkpointed_tempered(
        tmc, make_data(nev=GEN.NEV), GEN.CKPT_STEPS, GEN.CKPT_BF,
        segment_steps=GEN.CKPT_SEG, checkpoint_path=str(tmp_path / "t.npz"),
        stream_fn=interop.segment_draws(segs))
    np.testing.assert_allclose(ls.samples, REF["ckpt_tempered_samples"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ls.nll_values, REF["ckpt_tempered_nll"],
                               atol=1e-3)
    assert 0.0 <= tmc.last_swap_rate <= 1.0


def test_checkpointed_hmc_equals_uncheckpointed():
    """Segments of a phase are the phase cut up: fed the same draws, the
    checkpointed HMC keeps exactly the uninterrupted sampler's chain."""
    import tempfile

    data = make_data(nev=GEN.NEV)
    nsteps, bf = GEN.HMC_STEPS, GEN.HMC_BF
    whole = HMC(*inputs(), device="cpu")(data, nsteps, bf,
                                         presampler=jax_draws("hmc", [0]))
    draws = jax_draws("hmc", [0])
    warmup = max(int(nsteps * bf), 10)
    cuts = [(0, a, min(a + 7, warmup)) for a in range(0, warmup, 7)]
    cuts += [(1, a, min(a + 7, nsteps - warmup))
             for a in range(0, nsteps - warmup, 7)]

    def stream_fn(phase, seg, n):
        p, a, b = cuts[seg]
        assert (p, b - a) == (phase, n)
        full = draws(p, warmup if p == 0 else nsteps - warmup)
        return tuple(x[a:b] for x in full)

    with tempfile.TemporaryDirectory() as work:
        ls = checkpoint.run_checkpointed_hmc(
            HMC(*inputs(), device="cpu"), data, nsteps, bf, segment_steps=7,
            checkpoint_path=work + "/h.npz", stream_fn=stream_fn)
    np.testing.assert_array_equal(ls.samples, whole.samples)
    np.testing.assert_array_equal(ls.nll_values, whole.nll_values)


def test_seed_mismatch_starts_afresh(tmp_path):
    data = make_data(nev=GEN.NEV)
    path = str(tmp_path / "c.npz")
    run = lambda seed: checkpoint.run_checkpointed(  # noqa: E731
        MCMC(*inputs(), device="cpu"), data, 20, 0.2, segment_steps=5,
        checkpoint_path=path, seed=seed)
    first = run(1)
    again = run(2)      # the file is seed 1's: not resumed
    assert int(checkpoint.load_chain_state(path)["seed"]) == 2
    assert not np.array_equal(first.samples, again.samples)
