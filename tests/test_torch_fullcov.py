"""Full-covariance (Haario) proposals: B4's tril form and the full_cov
runners against the JAX package on identical inputs.

* The plain version of B4-tril (one chain, and three lock-step chains,
  each with its own tril) against the JAX Pallas kernel in interpret
  mode (a PdfStack built under ``force_pallas_interpret``), fed the same
  noise: identical accept decisions, parameters within 1e-6 relative
  (XLA may contract a proposal into an FMA), |dNLL| <= 1e-3 (NLL_TOL, as
  test_torch_kernels.py: XLA's CPU log vs torch's, compensated float32
  pairs vs float64 sums).
* ``retune_scale_tril`` against the JAX one on the same phase samples:
  a fixed parameter (zero row), a degenerate phase (the previous tril
  kept), per chain.  Within 1e-5 relative: two float32 Cholesky
  factorisations (LAPACK's and XLA's) round differently.
* ``MCMC(..., proposal="full_cov")``, one chain and three, fed the JAX
  streams through ``interop``, against ``_run_chains_fullcov``: the same
  accept decisions at every step.  Parameters within 1e-5 relative: each
  retune factorises the phase covariance in float32 (LAPACK here, XLA
  there, ~1e-6 apart) and the chain carries that along.  With fixed
  systematics both take the stepper (accept ``u <= exp(delta)``), NLLs
  within NLL_TOL.  With floating systematics the port takes the fused
  route (accept ``log(u) <= delta``, the proposal summed in ascending
  order as the TPU kernel does) and the JAX CPU stack its stepper (an
  XLA dot): they decide alike except within rounding of that boundary,
  and an ulp of a proposal can move an MC sample across a bin edge under
  the scale systematic, which moves the NLL by ~1e-2 at these 3,000 MC
  rows: NLLs within FUSED_NLL_TOL = 0.05, far below the 0.5 dNLL the
  intervals resolve.
* The ValueError on incompatible options, and ``run_ensemble`` end to
  end on tests/data/golden/.
"""

import json
import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them.
torch.set_num_threads(1)

NLL_TOL = 1e-3
FUSED_NLL_TOL = 0.05  # see the module docstring
NSTEPS = 8
N_MC = 1000  # MC rows per signal of the Pallas-interpret stacks
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")


def _tril(mcmc, nch, seed=5):
    """Per-chain lower-triangular scales: the initial widths on the
    diagonal, small correlations below it, and a zero row pinning
    source c (parameter 2)."""
    rng = np.random.default_rng(seed)
    w = np.maximum(np.asarray(mcmc.initial_jump_widths(), np.float32), 0)
    out = []
    for c in range(nch):
        t = np.diag(w * (1.0 + 0.5 * c)).astype(np.float32)
        low = np.tril(rng.normal(0, 1, t.shape), -1).astype(np.float32)
        t += 0.3 * low * w[:, None]
        t[2] = 0.0
        out.append(t)
    return np.stack(out).astype(np.float32)


def _fit_stub(fixed):
    """What the retune reads of an MCMC: the fixed flags and nfloat."""
    fixed = np.asarray(fixed, bool)
    return types.SimpleNamespace(parameter_fixed=fixed,
                                 nfloat=int((~fixed).sum()))


def test_retune_scale_tril_matches_jax():
    fit = _fit_stub([False, False, True, False, False])
    npar, n = 5, 300
    rng = np.random.default_rng(8)
    mix = rng.normal(0, 1, (npar, npar)).astype(np.float32)
    phase = (rng.normal(0, 1, (n, 2, npar)) @ mix * 0.05 + 1.0).astype(
        np.float32)
    phase[:, :, 2] = 1.0  # the fixed parameter never moves
    phase[:, 1] = 1.0  # chain 1: a degenerate phase (no move)
    tril = np.stack([np.diag(np.full(npar, 0.01 * (c + 1), np.float32))
                     for c in range(2)])
    got = tm.retune_scale_tril(fit, torch.as_tensor(tril),
                               torch.as_tensor(phase)).numpy()
    for c in range(2):
        want = np.asarray(jm.retune_scale_tril(fit, jnp.asarray(tril[c]),
                                               jnp.asarray(phase[:, c])))
        np.testing.assert_allclose(got[c], want, rtol=1e-5, atol=1e-8)
        one = tm.retune_scale_tril(fit, torch.as_tensor(tril[c]),
                                   torch.as_tensor(phase[:, c])).numpy()
        np.testing.assert_allclose(one, got[c], rtol=1e-5, atol=1e-8)
    assert (got[0][2] == 0).all()  # the fixed parameter's zero row
    assert (np.tril(got[0], -1) != 0).any()  # correlations found
    np.testing.assert_array_equal(got[1], tril[1])  # degenerate: kept


def same_walk(got, want, nch):
    """The same accept decisions (where each chain stayed) at every
    recorded step, and parameters within 1e-5 relative."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def stayed(s):
        s = s.reshape(nch, -1, s.shape[-1])
        return (np.diff(s, axis=1) == 0).all(axis=-1)

    np.testing.assert_array_equal(stayed(got), stayed(want))
    assert stayed(got).any() and not stayed(got).all()


_presample = jax.jit(jm._presample, static_argnums=(1, 2))


def _single_streams(chain_key, lengths, npar):
    """_run_single_chain(_fullcov)'s per-phase streams of one chain:
    split(key, 3), then the scan's per-step split (_presample, m = 0,
    under jit as the JAX runner draws them)."""
    return [_presample(jax.random.split(k, n), npar, 0)
            for k, n in zip(jax.random.split(chain_key, 3), lengths)]


@pytest.mark.parametrize("nch,fixed", [(1, False), (3, False), (3, True)])
def test_mcmc_full_cov_fed_jax_streams(nch, fixed):
    nsteps, frac = 60, 0.34  # three phases of 20: one stream compile
    burnin = int(nsteps * frac)
    lengths = (burnin, burnin, nsteps - 2 * burnin)
    jin, tin = make_stack_inputs("sxmc_tpu"), make_stack_inputs(
        "sxmc_tpu_torch")
    for s in (jin[2] + tin[2] if fixed else []):
        s.fixed = True
    jmc = jm.MCMC(*jin)
    tmc = tm.MCMC(*tin, device="cpu")
    assert tm._fused_ok(tmc) is not fixed
    key = jax.random.PRNGKey(19 + nch)
    jls = jmc(make_data(), nsteps, frac, key=key, nchains=nch,
              proposal="full_cov")
    # Every chain's streams (vmapped single chains), stacked on the chain
    # axis: (n, nchains, 1, npar) as interop.stream takes them.
    per_chain = [_single_streams(k, lengths, jmc.nparameters)
                 for k in jax.random.split(key, nch)]
    streams = []
    for p in range(3):
        noise = np.stack([np.asarray(c[p][0]) for c in per_chain], axis=1)
        u = np.stack([np.asarray(c[p][1]) for c in per_chain], axis=1)
        streams.append((noise[:, 0], u[:, 0]) if nch == 1 else (noise, u))
    tls = tmc(make_data(), nsteps, frac, nchains=nch, proposal="full_cov",
              presampler=interop.presampler(streams))
    assert tls.samples.shape == (nch * lengths[2], tmc.nparameters)
    same_walk(tls.samples, jls.samples, nch)
    np.testing.assert_allclose(tls.nll_values, jls.nll_values, rtol=0,
                               atol=NLL_TOL if fixed else FUSED_NLL_TOL)
    assert tmc.last_accept_rate == pytest.approx(jmc.last_accept_rate,
                                                 abs=1e-6)
    if fixed:  # zero tril rows pin the fixed systematics
        assert (tls.samples[:, 3:] == 0.0).all()


@pytest.mark.parametrize("kw", [dict(rate_substeps=2),
                                dict(pool_adaptation=True)])
def test_full_cov_incompatible_options_raise(kw):
    tmc = tm.MCMC(*make_stack_inputs("sxmc_tpu_torch"), device="cpu")
    with pytest.raises(ValueError, match="incompatible") as got:
        tmc(make_data(), 50, 0.2, generator=torch.Generator(),
            proposal="full_cov", **kw)
    jmc = jm.MCMC(*make_stack_inputs("sxmc_tpu"))
    with pytest.raises(ValueError) as want:
        jmc(make_data(), 50, 0.2, proposal="full_cov", **kw)
    assert str(got.value) == str(want.value)


def test_run_ensemble_golden_full_cov(tmp_path):
    from sxmc_tpu_torch.ensemble import run_ensemble
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    with open(os.path.join(GOLDEN, "config.json")) as f:
        cfg = json.load(f)
    cfg["fit"].update(nexperiments=1, nsteps=300, output_format="npz",
                      proposal="full_cov")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    fc = FitConfig.from_json_file(str(path), data_root=GOLDEN)
    assert fc.proposal == "full_cov"
    out = str(tmp_path / "out")
    limits = run_ensemble(fc, out, device="cpu", verbose=False)
    assert len(limits) == 1 and np.isfinite(limits[0])
    ls = LikelihoodSpace.load(os.path.join(out, "golden_0.npz"))
    assert ls.samples.shape == (180, 3) and np.isfinite(ls.nll_values).all()
    with open(os.path.join(out, "golden_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert "experiment_failed" not in [r["event"] for r in recs]
    fit = [r for r in recs if r["event"] == "experiment_fit"][0]
    assert 0.02 < fit["accept_rate"] < 0.95
