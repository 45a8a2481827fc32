"""The JAX package's runs for the tests of the port's KDE signals and
pooled adaptation.

    python tests/data/kde_reference/make_reference.py

from the root of the checkout (jax on the CPU; about a minute, most of
it compiling the JAX samplers) writes ``reference.npz`` beside this
file.  tests/test_torch_kde_fit.py, test_torch_kde_sharded.py and
test_torch_pooled.py hold sxmc_tpu_torch against it: the same numpy
inputs (``test_torch_kde.make_kde_inputs`` / ``make_kde_data``, and
``test_torch_pdf.make_stack_inputs`` / ``make_data`` for the pooled
chains) go through the port, fed the streams that the JAX package
derived from its keys, stored here in the port's layout:

  * Metropolis on a KDE stack (grid and ``kde_exact``, a floating shift
    on both signals): two chains of ``_run_single_chain`` from
    ``split(PRNGKey(MET_KEY), 2)``, each phase's streams
    ``_presample(split(k_phase, n), npar, 0)`` from ``k1, k2, k3 =
    split(chain_key, 3)``;
  * HMC's potential and its ``jax.grad`` (``_make_hmc_fns``) at the
    start and at a moved point, and ``MCMC.nll`` at the means;
  * the MLE of the grid-KDE stack (``MLE.fit``);
  * the sharded ensemble with ``kde_exact``: its fake datasets, its
    chains' streams (experiment e's chains from ``split(fold_in(key,
    1000 + e), nchains)``, then as a single chain) and its samples;
  * ``_run_chains_pooled`` (joint, and blocked with M = 2): each
    chain's phase streams from ``keys3 = split(chain_key, 3)`` and the
    kept samples; the widths after each burn-in phase come from the
    same steps replayed here with the JAX package's own functions
    (``_make_stepper``, ``retune_width``), checked against the kept
    samples of the real run (equal but for an ulp: the real run is
    vmapped over the chains).
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sxmc_tpu.fitconfig import FitConfig  # noqa: E402
from sxmc_tpu.mcmc import hmc as j_hmc  # noqa: E402
from sxmc_tpu.mcmc import metropolis as j_met  # noqa: E402
from sxmc_tpu.parallel import ensemble as j_par  # noqa: E402
from sxmc_tpu.stats.mle import MLE  # noqa: E402

from test_torch_kde import make_kde_data, make_kde_inputs  # noqa: E402
from test_torch_pdf import make_data, make_stack_inputs  # noqa: E402

# The inputs; the tests read them from here.
MET_KEY, MET_STEPS, MET_BF, MET_CHAINS = 3, 60, 0.2, 2
HMC_Q_SHIFT = 0.05            # the moved point: q0 + this in every entry
SHARD_SEED, SHARD_NEXP, SHARD_CHAINS, SHARD_STEPS = 7, 2, 2, 40
POOL_KEY, POOL_STEPS, POOL_BF, POOL_CHAINS, POOL_M = 11, 60, 0.2, 3, 2
POOL_NMC, POOL_NEV = 600, 200

_presample = jax.jit(j_met._presample, static_argnums=(1, 2))


def phase_streams(key, nsteps, burnin, npar, m=0):
    """``[(noise, u)]`` of each phase of ``_run_single_chain`` (or, per
    chain, ``_run_chains_pooled``) from its three phase keys, in the
    ``_presample`` layout ``(n, m + 1, npar)``, ``(n, m + 1)``."""
    ks = jax.random.split(key, 3)
    lens = [burnin, burnin, nsteps - 2 * burnin]
    return [tuple(np.asarray(x) for x in _presample(
        jax.random.split(k, n), npar, m)) for k, n in zip(ks, lens)]


def metropolis_references(out):
    data = make_kde_data()
    burnin = int(MET_STEPS * MET_BF)
    for exact in (False, True):
        tag = "exact" if exact else "grid"
        mcmc = j_met.MCMC(*make_kde_inputs("sxmc_tpu", exact=exact))
        mcmc.stack.set_data(data)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        for c, ck in enumerate(jax.random.split(
                jax.random.PRNGKey(MET_KEY), MET_CHAINS)):
            s, nl, acc = j_met._run_single_chain(
                mcmc, ck, rb, dd, nsteps=MET_STEPS, burnin_steps=burnin,
                debug_mode=False)
            out[f"met_{tag}_samples_c{c}"] = np.asarray(s)
            out[f"met_{tag}_nlls_c{c}"] = j_met.nll_history_to_f64(nl)
            for p, (noise, u) in enumerate(phase_streams(
                    ck, MET_STEPS, burnin, mcmc.nparameters)):
                out[f"met_{tag}_noise_p{p}_c{c}"] = noise
                out[f"met_{tag}_u_p{p}_c{c}"] = u


def hmc_references(out):
    data = make_kde_data()
    for exact in (False, True):
        tag = "exact" if exact else "grid"
        hmc = j_hmc.HMC(*make_kde_inputs("sxmc_tpu", exact=exact))
        hmc.stack.set_data(data)
        fns = j_hmc._make_hmc_fns(hmc, hmc.stack._read_bins,
                                  hmc.stack.device_data, 4, 0.8)
        for name, q in (("q0", fns.q0), ("q1", fns.q0 + HMC_Q_SHIFT)):
            out[f"hmc_{tag}_{name}"] = np.asarray(q)
            out[f"hmc_{tag}_u_{name}"] = np.asarray(fns.potential(q))
            out[f"hmc_{tag}_g_{name}"] = np.asarray(
                jax.grad(fns.potential)(q))
        out[f"nll_{tag}_means"] = np.asarray(
            hmc.nll(data, hmc.parameter_means))


def mle_references(out):
    mle = MLE(*make_kde_inputs("sxmc_tpu", exact=False))
    res = mle.fit(make_kde_data())
    out["mle_params"] = np.asarray(res.params)
    out["mle_nll"] = np.asarray(res.nll)
    out["mle_converged"] = np.asarray(res.converged)


def sharded_references(out):
    srcs, sigs, systs, obs = make_kde_inputs("sxmc_tpu", exact=True)
    fc = FitConfig(nexperiments=SHARD_NEXP, nsteps=SHARD_STEPS,
                   burnin_fraction=0.2, signal_name="sig",
                   seed=SHARD_SEED, nchains=SHARD_CHAINS, signals=sigs,
                   sources=srcs, systematics=systs, observables=obs)
    lspaces, limits = j_par.run_sharded_ensemble(fc, nsteps=SHARD_STEPS,
                                                 verbose=False)
    mcmc = j_met.MCMC(srcs, sigs, systs, obs)
    key = jax.random.PRNGKey(SHARD_SEED)
    for e, ls in enumerate(lspaces):
        out[f"shard_samples_e{e}"] = ls.samples  # chain-major
        out[f"shard_data_e{e}"] = np.asarray(j_par.make_fake_dataset(
            jax.random.fold_in(key, e), fc.signals, fc.systematics,
            fc.observables, poisson=True, stack=mcmc.stack))
        chain_keys = jax.random.split(jax.random.fold_in(key, 1000 + e),
                                      SHARD_CHAINS)
        for c, ck in enumerate(chain_keys):
            for p, (noise, u) in enumerate(phase_streams(
                    ck, SHARD_STEPS, int(SHARD_STEPS * 0.2),
                    mcmc.nparameters)):
                out[f"shard_noise_p{p}_e{e}_c{c}"] = noise
                out[f"shard_u_p{p}_e{e}_c{c}"] = u
    out["shard_limits"] = np.asarray(limits)


def pooled_references(out):
    data = make_data(nev=POOL_NEV)
    burnin = int(POOL_STEPS * POOL_BF)
    for m in (0, POOL_M):
        mcmc = j_met.MCMC(*make_stack_inputs("sxmc_tpu", n_mc=POOL_NMC))
        mcmc.stack.set_data(data)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        keys = jax.random.split(jax.random.PRNGKey(POOL_KEY), POOL_CHAINS)
        samples, nlls, _ = j_met._run_chains_pooled(
            mcmc, keys, rb, dd, POOL_STEPS, burnin, False, rate_substeps=m)
        out[f"pool{m}_samples"] = np.asarray(samples)  # (chains, n, npar)
        out[f"pool{m}_nlls"] = j_met.nll_history_to_f64(nlls)
        streams = [phase_streams(k, POOL_STEPS, burnin, mcmc.nparameters,
                                 m) for k in keys]
        for c, st in enumerate(streams):
            for p, (noise, u) in enumerate(st):
                out[f"pool{m}_noise_p{p}_c{c}"] = noise
                out[f"pool{m}_u_p{p}_c{c}"] = u
        # The same phases step by step, for the widths between them.
        step, init_extras, mm = j_met._make_stepper(mcmc, rb, dd, False, m)
        carries = []
        for c in range(POOL_CHAINS):
            p0, n0, w0 = j_met.initial_state(mcmc, rb, dd)
            carries.append((p0, n0, w0) + tuple(init_extras(p0)))
        scan = jax.jit(lambda carry, xs: jax.lax.scan(step, carry, xs))
        for p in range(3):
            phase = [scan(carries[c], tuple(jnp.asarray(x)
                                            for x in streams[c][p]))
                     for c in range(POOL_CHAINS)]
            carries = [o[0] for o in phase]
            if p < 2:
                pooled = jnp.concatenate([o[1][0] for o in phase])
                w = j_met.retune_width(mcmc, carries[0][2], pooled)
                out[f"pool{m}_width_p{p}"] = np.asarray(w)
                carries = [cr[:2] + (w,) + cr[3:] for cr in carries]
            else:
                replay = np.stack([np.asarray(o[1][0]) for o in phase])
                # Unvmapped, a step may round an ulp apart.
                np.testing.assert_allclose(
                    replay, out[f"pool{m}_samples"], rtol=1e-6, atol=1e-7)


def main():
    out = {}
    metropolis_references(out)
    hmc_references(out)
    mle_references(out)
    sharded_references(out)
    pooled_references(out)
    np.savez_compressed(os.path.join(HERE, "reference.npz"), **out)
    print(f"wrote {len(out)} arrays")


if __name__ == "__main__":
    main()
