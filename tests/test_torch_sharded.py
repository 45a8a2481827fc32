"""The sharded ensemble (``sxmc_tpu_torch.parallel``): the experiment-
grouped forms of B4 and B5 and ``run_sharded_ensemble`` against the JAX
package on identical inputs.

* The plain versions of the grouped forms (B4 diagonal, tril and
  weighted; B5) against the JAX package's ``_batched_segment_fused`` on
  a 1-device mesh, its Pallas kernels in interpret mode, fed the same
  ``_segment_keys`` + ``_presample`` streams (``interop.segment_streams``)
  from the same state (``interop.ensemble_state``): identical accept
  decisions, parameters within 1e-6 relative, |dNLL| <= 1e-3 (as
  test_torch_kernels.py: XLA may contract a proposal into an FMA; XLA's
  CPU log vs torch's, compensated float32 pairs vs float64 sums).
* ``_sharded_retune`` / ``_sharded_retune_cov`` against the JAX ones on
  the same running moments: 1e-6 and 1e-5 relative (two float32
  Cholesky factorisations, as test_torch_fullcov.py).
* ``run_sharded_ensemble`` fed the JAX datasets and streams, against
  the JAX runner (both on one device), through both retunes on every
  route: grouped diagonal, tril (full_cov) and blocked (rate_substeps),
  and per experiment (fixed systematics: the JAX runner's vmapped
  ``_run_single_chain``, the port's ``run_chain``).  The same accept
  decisions at every recorded step; parameters and limits within 1e-3
  relative, NLLs within 1e-2.  Looser than a segment's bar because the diagonal
  retune takes the one-pass variance E[x^2] - E[x]^2 in float32, which
  cancels: its relative error is an ulp of E[x^2] over the variance.
  The two libraries' proposals differ by an ulp (XLA's FMA), and for a
  rate that moved a few times in a 10-step burn-in (variance ~1e-5)
  that becomes ~1e-3 of the retuned width, which the chain carries on
  (1.7e-4 of a rate here, and ~1e-3 of NLL per 1e-4 of a rate).
* Pad rows add exactly 0; a killed run resumes bit for bit; the batch
  splits into launches of whole experiments past the chain caps;
  ``--sharded --device cpu`` runs end to end on tests/data/golden/.

On the grouped routes the JAX runner runs on the fixture's MCMC and
datasets, and its phase is the segment tests' length, so that it reuses
their compiled kernels (interpret-mode compiles are most of this file's
time).
"""

import functools
import importlib
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sxmc_tpu.mcmc import metropolis as jm
from sxmc_tpu.parallel import ensemble as jpe
from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm
from sxmc_tpu_torch.observability import MetricsLogger
from sxmc_tpu_torch.parallel import ensemble as tpe

from test_torch_pdf import make_data
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

NLL_TOL = 1e-3
RUN_REL, RUN_NLL_TOL = 1e-3, 1e-2  # whole runs; see the module docstring
NEXP, CPE = 2, 2
NSTEPS = 10  # a segment, and each phase of the 30-step runs (burn-in 1/3)
N_MC = 700  # MC rows per signal
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")


def _inputs(pkg, weighted=False):
    """A small fit in package ``pkg``: signal "a" under a scale
    systematic (a dynamic segment, dataset 0) and "b" without one (a
    static row, dataset 1), N_MC rows each, about 200 events an
    experiment; weighted: log-normal weights on both."""
    sig = importlib.import_module(pkg + ".signal")
    rng = np.random.default_rng(3)
    obs = sig.Observable(name="energy", field="energy", bins=10, lower=5.0,
                         upper=15.0, field_index=0)
    scale = sig.Systematic(name="scale", type=1, observable_field="energy",
                           means=[0.0], sigmas=[0.02],
                           observable_field_index=0, pidx=[0])
    srcs = [sig.Source(name="a", index=0, mean=1.0, sigma=0.0),
            sig.Source(name="b", index=1, mean=1.0, sigma=0.1)]
    tables = [rng.normal(10.0, 1.5, (N_MC, 1)),
              rng.uniform(5.0, 15.0, (N_MC, 1))]
    sigs = [sig.Signal.from_table(
        name, name, t.astype(np.float32), ["energy"], ds, src, rate,
        ["energy", "DATASET"], [obs], [], systs)
        for name, t, ds, src, rate, systs in (
            ("a", tables[0], 0, srcs[0], 120.0, [scale]),
            ("b", tables[1], 1, srcs[1], 80.0, []))]
    if weighted:
        w = rng.lognormal(0.0, 0.3, (2, N_MC)).astype(np.float32)
        for s, ws in zip(sigs, w):
            s.histogram.weights = ws
    return srcs, sigs, [scale], [obs]


def _fit_config(pkg, **fit):
    """The _inputs fit as a FitConfig of package ``pkg``: NEXP
    experiments x CPE chains, 3 x NSTEPS steps."""
    srcs, sigs, systs, obs = _inputs(pkg)
    kw = dict(nexperiments=NEXP, nsteps=3 * NSTEPS, burnin_fraction=1 / 3,
              signal_name="a", seed=3, nchains=CPE, observables=obs,
              systematics=systs, sources=srcs, signals=sigs)
    kw.update(fit)
    return importlib.import_module(pkg + ".fitconfig").FitConfig(**kw)


def _one_device():
    """The JAX package's {exp, chain} mesh on one device (its layout on
    one card, as the port's)."""
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                axis_names=("exp", "chain"))


@pytest.fixture(scope="module")
def setup():
    """``{weighted: (jmc, tmc, jrb, trb)}``: the JAX MCMC (Pallas
    interpret mode) and the port's (CPU) of the fit, and both packages'
    read bins of NEXP padded datasets of different sizes (events on [4,
    16) with tags 0, 1 and 7), kept under ``"datasets"``.  The read bins
    depend on the binning and the signals' dataset tags only, the same
    weighted or not."""
    from sxmc_tpu.pdf.stack import force_pallas_interpret

    datasets = [make_data(seed=9 + e, nev=300 - 70 * e)
                for e in range(NEXP)]
    out = {"datasets": datasets}
    for weighted in (False, True):
        with force_pallas_interpret():
            jmc = jm.MCMC(*_inputs("sxmc_tpu", weighted))
        assert jmc.stack.supports_fused
        tmc = tm.MCMC(*_inputs("sxmc_tpu_torch", weighted), device="cpu")
        jrb = (out[False][2] if weighted else
               jmc.stack.compute_read_bins(jpe.pad_datasets(datasets)))
        out[weighted] = (jmc, tmc, jrb, tmc.stack.compute_read_bins(
            tpe.pad_datasets(datasets)))
    return out


def test_pad_rows_and_read_bins(setup):
    """The port pads and bins the batch as JAX does; pad rows carry a
    sentinel (-1: zero is out of this domain) in every signal's row and
    add exactly 0: the smaller experiment's NLL is the same with and
    without its pad rows."""
    _, tmc, jrb, trb = setup[False]
    np.testing.assert_array_equal(setup[True][3].numpy(), trb.numpy())
    datasets = setup["datasets"]
    np.testing.assert_array_equal(tpe.pad_datasets(datasets),
                                  jpe.pad_datasets(datasets))
    np.testing.assert_array_equal(trb.numpy(), np.asarray(jrb))
    sizes = [d.shape[0] for d in datasets]
    e = int(np.argmin(sizes))
    assert sizes[e] < max(sizes)
    assert (trb[e, :, sizes[e]:] == -1).all()
    assert (trb[e] == -2).any()  # events of the other signal's dataset
    p = torch.as_tensor(tmc.parameter_means).expand(2, -1).contiguous()
    padded = tmc.stack.fused_nll_pair_batch(p, trb[e], tmc.nll_spec)
    own = tmc.stack.fused_nll_pair_batch(
        p, trb[e, :, :sizes[e]].contiguous(), tmc.nll_spec)
    for a, b in zip(padded, own):
        assert torch.equal(a, b)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_streams(keys, n, npar, m):
    """The JAX segment streams of _batched_segment_fused: per (exp,
    chain) key, _presample of split(key, n) (under jit, as the JAX
    runner draws them; op by op each new shape compiles anew)."""
    return jax.vmap(jax.vmap(
        lambda k: jm._presample(jax.random.split(k, n), npar, m)))(keys)


def _jax_segment(jmc, params, hi, lo, width, keys, rb, m):
    """``_batched_segment_fused`` with the inputs placed on the mesh as
    ``_run_sharded_ensemble_segmented`` places them (so that the runner
    hits the same compiled kernel)."""
    mesh = _one_device()
    shard = NamedSharding(mesh, P("exp", "chain"))
    put = lambda x: jax.device_put(jnp.asarray(x), shard)  # noqa: E731
    with mesh:
        return jpe._batched_segment_fused(
            jmc, put(params), (put(hi), put(lo)), put(width), put(keys),
            jax.device_put(rb, NamedSharding(mesh, P("exp"))),
            jmc.stack.device_data, NSTEPS, False, mesh, m)


@pytest.mark.parametrize("form", ["diagonal", "tril", "weighted", "blocked"])
def test_grouped_segment_matches_jax(setup, form):
    jmc, tmc, jrb, trb = setup[form == "weighted"]
    npar = jmc.nparameters
    m = 1 if form == "blocked" else 0
    rng = np.random.default_rng(3)
    params = np.tile(np.asarray(jmc.parameter_means, np.float32),
                     (NEXP, CPE, 1))
    params[..., :2] += rng.uniform(-0.05, 0.05, (NEXP, CPE, 2))
    params = params.astype(np.float32)
    w = np.asarray(jmc.initial_jump_widths(), np.float32)
    width = np.tile(w, (NEXP, CPE, 1))
    if form == "tril":
        low = np.tril(rng.normal(0, 1, (NEXP, CPE, npar, npar)), -1)
        w = np.maximum(w, 0)
        width = (np.diag(w) + 0.3 * low * w[:, None]).astype(np.float32)
    # Both start from the port's NLLs (B3's plain version, per experiment).
    pairs = [tmc.stack.fused_nll_pair_batch(torch.as_tensor(params[e]),
                                            trb[e], tmc.nll_spec)
             for e in range(NEXP)]
    hi = np.stack([p[0].numpy() for p in pairs])
    lo = np.stack([p[1].numpy() for p in pairs])
    keys = jpe._segment_keys(jax.random.PRNGKey(5), NEXP, CPE, 0, 0)
    _, _, j_s, j_n, _ = _jax_segment(jmc, params, hi, lo, width, keys, jrb,
                                     m)
    noise, u = interop.segment_streams(
        {(0, 0): _jax_streams(keys, NSTEPS, npar, m)})(0, 0, NSTEPS)
    run = {"tril": tmc.stack.fused_segment_tril_grouped,
           "blocked": tmc.stack.blocked_segment_grouped}.get(
        form, tmc.stack.fused_segment_grouped)
    # The batched state as the JAX runner carries it, into the port's.
    tp, (thi, tlo), tw = interop.ensemble_state(params, (hi, lo), width)
    t_s, t_n, t_a = run(tp, torch.stack([thi, tlo], dim=-1), tw, trb, noise,
                        torch.log(u), tmc.nll_spec)
    assert t_s.shape == (NSTEPS, NEXP, CPE, npar)
    got = t_s.movedim(0, 2).numpy()
    want = np.asarray(j_s)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # The same decisions: where each chain stayed.
    stayed = lambda s: (np.diff(s, axis=2) == 0).all(axis=-1)  # noqa: E731
    np.testing.assert_array_equal(stayed(got), stayed(want))
    assert stayed(got).any() and not stayed(got).all()
    t_nll = t_n.double().sum(-1).movedim(0, 2).numpy()
    j_nll = np.asarray(j_n[0], np.float64) + np.asarray(j_n[1], np.float64)
    np.testing.assert_allclose(t_nll, j_nll, rtol=0, atol=NLL_TOL)
    # The two experiments' chains saw their own events.
    assert not np.array_equal(t_nll[0], t_nll[1])


def test_sharded_retunes_match_jax(setup):
    jmc, tmc, _, _ = setup[False]
    npar = jmc.nparameters
    rng = np.random.default_rng(11)
    hist = (np.asarray(jmc.parameter_means, np.float32)
            + rng.normal(0, 0.1, (NEXP, CPE, 300, npar))).astype(np.float32)
    hist[1, 1] = hist[1, 1, :1]  # a chain that never moved
    n = np.float32(hist.shape[2])
    w0 = np.tile(np.asarray(jmc.initial_jump_widths(), np.float32),
                 (NEXP, CPE, 1))
    moments = (hist.sum(axis=2), (hist * hist).sum(axis=2))
    got = tpe._sharded_retune(tmc, torch.as_tensor(w0), torch.tensor(n),
                              *map(torch.as_tensor, moments))
    # Eager, as the JAX runner calls it (inside jit XLA would fuse E[x^2]
    # - E[x]^2 into one rounding, and the chain that never moved would
    # retune differently).
    want = jpe._sharded_retune(jmc, jnp.asarray(w0), n,
                               *map(jnp.asarray, moments))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    xc = hist - hist[:, :, :1]
    tril0 = np.tile(np.diag(np.maximum(w0[0, 0], 0)), (NEXP, CPE, 1, 1))
    moments = (xc.sum(axis=2), np.einsum("ecsi,ecsj->ecij", xc, xc))
    got = tpe._sharded_retune_cov(tmc, torch.as_tensor(tril0),
                                  torch.tensor(n),
                                  *map(torch.as_tensor, moments))
    want = jpe._sharded_retune_cov(jmc, jnp.asarray(tril0), n,
                                   *map(jnp.asarray, moments))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_array_equal(got[1, 1].numpy(), tril0[1, 1])  # kept


# Each route's fit edits; "fixed" fixes the scale systematic.
ROUTES = {"diagonal": {}, "full_cov": {"proposal": "full_cov"},
          "rate_substeps": {"rate_substeps": 1}, "fixed": {}}


def _per_experiment_streams(key, npar):
    """The streams of the JAX runner's vmapped ``_run_single_chain``:
    chain c of experiment i keyed split(fold_in(key, 1000 + i))[c], its
    phases split(that, 3), each phase _presample of split(k, n)."""
    keys = jnp.stack([jax.random.split(jax.random.fold_in(key, 1000 + i),
                                       CPE) for i in range(NEXP)])
    k3 = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 3)))(keys)
    return {(phase, 0): _jax_streams(k3[:, :, phase], NSTEPS, npar, 0)
            for phase in range(3)}


def _compare_runs(setup, monkeypatch, tmp_path, route):
    """The JAX runner and the port's on the same datasets, the port fed
    the JAX runner's streams.  Grouped routes: the JAX runner runs on
    the fixture's MCMC (interpret mode; its segments at the grouped
    segment test's shapes reuse that test's compiled kernel) with the
    _segment_keys streams.  "fixed": both take the per-experiment route
    (a JAX CPU stack, its vmapped stepper), fed its per-chain streams."""
    fit = ROUTES[route]
    jfc = _fit_config("sxmc_tpu", **fit)
    tfc = _fit_config("sxmc_tpu_torch", **fit)
    datasets = iter(setup["datasets"])
    monkeypatch.setattr(jpe, "make_fake_dataset",
                        lambda *args, **kwargs: next(datasets))
    key = jax.random.PRNGKey(jfc.seed)
    npar = setup[False][0].nparameters
    if route == "fixed":
        for fc in (jfc, tfc):
            fc.systematics[0].fixed = True  # signal "a"'s systematic
        segments = _per_experiment_streams(key, npar)
        expect = "per experiment"
    else:
        jmc = setup[False][0]
        monkeypatch.setattr(jpe, "MCMC", lambda *args, **kwargs: jmc)
        m = fit.get("rate_substeps", 0)
        segments = {(phase, 0): _jax_streams(
            jpe._segment_keys(key, NEXP, CPE, phase, 0), NSTEPS, npar, m)
            for phase in range(3)}
        expect = "grouped"
    jls, jlim = jpe.run_sharded_ensemble(jfc, mesh=_one_device(),
                                         verbose=False)
    metrics = tmp_path / "metrics.jsonl"
    tls, tlim = tpe.run_sharded_ensemble(
        tfc, device="cpu", verbose=False,
        dataset_fn=lambda i: setup["datasets"][i],
        stream_fn=interop.segment_streams(segments),
        metrics=MetricsLogger(str(metrics)))
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["route"] for r in recs if r["event"] == "sharded_fit"] == [
        expect]
    for t, j in zip(tls, jls):
        got = t.samples.reshape(CPE, NSTEPS, -1)
        want = j.samples.reshape(got.shape)
        stayed = lambda s: (np.diff(s, axis=1) == 0).all(-1)  # noqa: E731
        np.testing.assert_array_equal(stayed(got), stayed(want))
        assert stayed(got).any() and not stayed(got).all()
        np.testing.assert_allclose(got, want, rtol=RUN_REL, atol=1e-6)
        np.testing.assert_allclose(t.nll_values, j.nll_values, rtol=0,
                                   atol=RUN_NLL_TOL)
    np.testing.assert_allclose(tlim, jlim, rtol=RUN_REL)


