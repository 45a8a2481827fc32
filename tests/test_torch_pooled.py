"""Pooled adaptation (``MCMC(..., pool_adaptation=True)``) against the
JAX package's ``_run_chains_pooled``.

The JAX runs, each chain's phase streams and the widths after each
burn-in phase are stored by tests/data/kde_reference/make_reference.py
(the JAX runner compiles for tens of seconds).  Fed those streams, the
port's lock-step chains (the fused route: B4-batched, or B5-batched with
rate_substeps, as plain versions on the CPU; accept ``log(u) <= delta``
where JAX's stepper takes ``u <= exp(delta)``, alike except within
rounding of a tie) must retune to JAX's widths, one width for every
chain, within 1e-6 relative (the replayed JAX steps round an ulp apart
from the vmapped run), and keep JAX's samples within 1e-5 relative.
"""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

REF_DIR = pathlib.Path(__file__).resolve().parent / "data" / "kde_reference"


def load_reference():
    spec = importlib.util.spec_from_file_location(
        "kde_make_reference", REF_DIR / "make_reference.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen, dict(np.load(REF_DIR / "reference.npz"))


GEN, REF = load_reference()


def _recording(monkeypatch):
    """Record every pooled retune's widths."""
    widths = []
    real = tm.pooled_retune

    def record(mcmc, width, samples):
        new = real(mcmc, width, samples)
        widths.append(new.clone())
        return new

    monkeypatch.setattr(tm, "pooled_retune", record)
    return widths


@pytest.mark.parametrize("m", [0, GEN.POOL_M])
def test_pooled_widths_and_samples_match_jax(m, monkeypatch):
    widths = _recording(monkeypatch)
    mc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch", n_mc=GEN.POOL_NMC),
                 device="cpu")
    nch = GEN.POOL_CHAINS
    phases = [tuple(np.stack([REF[f"pool{m}_{x}_p{p}_c{c}"]
                              for c in range(nch)], axis=1)
                    for x in ("noise", "u")) for p in range(3)]
    ls = mc(make_data(nev=GEN.POOL_NEV), GEN.POOL_STEPS, GEN.POOL_BF,
            nchains=nch, rate_substeps=m, pool_adaptation=True,
            presampler=interop.presampler(phases))
    assert len(widths) == 2
    for p, w in enumerate(widths):
        assert (w == w[0]).all()  # one width for every chain
        np.testing.assert_allclose(w[0].numpy(), REF[f"pool{m}_width_p{p}"],
                                   rtol=1e-6)
    want = REF[f"pool{m}_samples"]
    np.testing.assert_allclose(ls.samples, want.reshape(-1, want.shape[-1]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ls.nll_values, REF[f"pool{m}_nlls"].reshape(
        -1), rtol=0, atol=1e-3)


def test_pooled_stepper_route(monkeypatch):
    """Fixed systematics take the stepper: the pooled widths still come
    from every chain's steps, and every chain walks with them."""
    widths = _recording(monkeypatch)
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch", n_mc=400)
    for s in systs:
        s.fixed = True
    mc = tm.MCMC(srcs, sigs, systs, obs, device="cpu")
    ls = mc(make_data(nev=150), 50, 0.2, nchains=3, pool_adaptation=True,
            generator=torch.Generator().manual_seed(3))
    assert len(widths) == 2 and ls.samples.shape == (3 * 30, 5)
    for w in widths:
        assert (w == w[0]).all()
        assert (w[0, 3:] == -1).all()  # the fixed systematics stay pinned
    assert np.isfinite(ls.nll_values).all()


def test_pooling_refusals_and_one_chain():
    """full_cov refuses pooling with the JAX package's message; one
    chain pools nothing and walks as without pooling."""
    from sxmc_tpu.mcmc import metropolis as jm

    mc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch", n_mc=300),
                 device="cpu")
    with pytest.raises(ValueError) as got:
        mc(make_data(nev=100), 50, 0.2, nchains=2, proposal="full_cov",
           pool_adaptation=True, generator=torch.Generator())
    with pytest.raises(ValueError) as want:
        jm.MCMC(*make_stack_inputs("sxmc_tpu", n_mc=300))(
            make_data(nev=100), 50, 0.2, nchains=2, proposal="full_cov",
            pool_adaptation=True)
    assert str(got.value) == str(want.value)
    runs = [mc(make_data(nev=100), 50, 0.2, pool_adaptation=pool,
               generator=torch.Generator().manual_seed(5)).samples
            for pool in (False, True)]
    assert np.array_equal(runs[0], runs[1])


def test_new_modules_import_no_jax():
    """The modules of this slice (KDE, the native store, the converter,
    pooling) import neither jax nor sxmc_tpu."""
    code = ("import sys\n"
            "import sxmc_tpu_torch.pdf.evalkde, sxmc_tpu_torch.io.native\n"
            "import sxmc_tpu_torch.io.convert, sxmc_tpu_torch.pdf.stack\n"
            "import sxmc_tpu_torch.mcmc.metropolis\n"
            "import sxmc_tpu_torch.parallel.ensemble\n"
            "bad = [m for m in sys.modules if m in ('jax', 'sxmc_tpu') or "
            "m.startswith(('jax.', 'sxmc_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(REF_DIR.parents[2]), timeout=60)
