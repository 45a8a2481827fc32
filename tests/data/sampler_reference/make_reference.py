"""The JAX package's sampler runs for the tests of the port's HMC, NUTS,
stretch sampler and checkpoint runners.

    python tests/data/sampler_reference/make_reference.py

from the root of the checkout (jax on the CPU; a few minutes, most of it
compiling the JAX samplers) writes ``reference.npz`` beside this file.
tests/test_torch_hmc.py, test_torch_stretch.py and
test_torch_checkpoint.py hold sxmc_tpu_torch against it: the same numpy
inputs (``test_torch_pdf.make_stack_inputs`` / ``make_data`` from their
seeds) go through the port, fed the draws that the JAX package derived
from its keys, which are stored here in the port's layout:

  * HMC and NUTS: two chains from ``split(PRNGKey(HMC_KEY), 2)``; per
    step the momentum normals and the accept uniform (``k_mom, k_acc =
    split(step_key)``, hmc.py:170-186; the warmup and sampling keys from
    ``split(key)`` then ``split(k, n)``, :235-251), and for NUTS per
    level the direction uniform (``bernoulli(k, 0.5)`` is ``uniform(k)
    < 0.5``), the merge uniform and the subtree's leaf uniforms from its
    sequential ``split`` (nuts.py:155-160, 185-187, 199-203, 256);
  * the stretch move: two ensembles from ``split(PRNGKey(STRETCH_KEY),
    2)``; the initial cloud's normals and per half-move the z uniforms,
    partner indices and accept uniforms (``split(step_key, 3)``,
    stretch.py:132-137, 150-152);
  * ``run_checkpointed`` (diagonal, full_cov, blocked) and
    ``run_checkpointed_tempered``: each segment's streams from the key
    chain ``key, seg_key = split(key)`` (checkpoint.py:112, 418), as
    ``_presample`` or ``_make_tempered_step``'s ``phase_keys`` draw them.

The JAX samplers compile for seconds to minutes per shape, which is why
their runs are made once, here, and not in every test run.
"""

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sxmc_tpu import checkpoint as j_ckpt  # noqa: E402
from sxmc_tpu.mcmc import hmc as j_hmc  # noqa: E402
from sxmc_tpu.mcmc import metropolis as j_met  # noqa: E402
from sxmc_tpu.mcmc import nuts as j_nuts  # noqa: E402
from sxmc_tpu.mcmc import stretch as j_stretch  # noqa: E402
from sxmc_tpu.mcmc import tempered as j_tempered  # noqa: E402

from test_torch_pdf import make_data, make_stack_inputs  # noqa: E402

# The inputs; the tests read them from here.
N_MC = 600
NEV = 200
NCHAINS = 2
HMC_KEY, HMC_STEPS, HMC_BF = 10, 40, 0.5       # warmup 20, sampling 20
NUTS_KEY, NUTS_STEPS, NUTS_BF, NUTS_DEPTH = 5, 24, 0.5, 8
STRETCH_KEY, STRETCH_STEPS, STRETCH_BF = 17, 30, 0.2
# Runs whose moments the port's runs on its own generator (the same
# steps, burn-in and chains) are held against statistically.
STAT_KEY, STAT_CHAINS, STAT_BF = 19, 4, 0.5
HMC_STAT_STEPS, NUTS_STAT_STEPS, STRETCH_STAT_STEPS = 60, 60, 200
CKPT_SEED, CKPT_STEPS, CKPT_BF, CKPT_SEG = 23, 40, 0.2, 5
CKPT_M = 2                                     # blocked rate moves
NTEMPS, TMAX, SWAP_EVERY = 3, 8.0, 3


def stack_inputs():
    return make_stack_inputs("sxmc_tpu", n_mc=N_MC)


def hmc_phase_draws(k, n, npar):
    """(momentum (n, npar), u (n,)) of ``n`` HMC steps from key k."""
    ks = jax.vmap(jax.random.split)(jax.random.split(k, n))
    mom = jax.vmap(lambda kk: jax.random.normal(kk, (npar,)))(ks[:, 0])
    u = jax.vmap(lambda kk: jax.random.uniform(kk, ()))(ks[:, 1])
    return np.asarray(mom), np.asarray(u)


def nuts_step_draws(step_key, npar, depth):
    k_mom, k_loop = jax.random.split(step_key)
    mom = jax.random.normal(k_mom, (npar,))
    dirs, merges, leaves = [], [], []
    for d, kd in enumerate(jax.random.split(k_loop, depth)):
        k_dir, k_sub, k_merge = jax.random.split(kd, 3)
        dirs.append(jax.random.uniform(k_dir, ()))
        merges.append(jax.random.uniform(k_merge, ()))
        key = k_sub
        for _ in range(2 ** d):
            key, k = jax.random.split(key)
            leaves.append(jax.random.uniform(k, ()))
    return mom, jnp.stack(dirs), jnp.stack(merges), jnp.stack(leaves)


def nuts_phase_draws(k, n, npar, depth):
    fn = jax.jit(jax.vmap(lambda kk: nuts_step_draws(kk, npar, depth)))
    return tuple(np.asarray(x) for x in fn(jax.random.split(k, n)))


def gradient_references(out, data):
    npar = 5
    for tag, cls, key, nsteps, bf in (
            ("hmc", j_hmc.HMC, HMC_KEY, HMC_STEPS, HMC_BF),
            ("nuts", j_nuts.NUTS, NUTS_KEY, NUTS_STEPS, NUTS_BF)):
        warmup = max(int(nsteps * bf), 10)
        keep = max(nsteps - warmup, 1)
        chain_keys = jax.random.split(jax.random.PRNGKey(key), NCHAINS)
        for binned in ((False, True) if tag == "hmc" else (False,)):
            s = cls(*stack_inputs(), binned=binned)
            s.stack.set_data(data)
            rb, dd = s.stack._read_bins, s.stack.device_data
            if tag == "hmc":
                samples, nlls, acc = j_hmc._run_hmc_chains(
                    s, chain_keys, rb, dd, warmup, keep, 16, 0.8)
            else:
                samples, nlls, acc = j_nuts._run_nuts_chains(
                    s, chain_keys, rb, dd, warmup, keep, NUTS_DEPTH, 0.8)
            pre = f"{tag}{'_binned' if binned else ''}_"
            out[pre + "samples"] = np.asarray(samples)
            out[pre + "nlls"] = np.asarray(nlls)
            out[pre + "accept"] = np.asarray(acc)
        # The draws, per phase (0 warmup, 1 sampling): (steps, chains, ...).
        for c, ck in enumerate(chain_keys):
            for phase, (k, n) in enumerate(zip(jax.random.split(ck),
                                               (warmup, keep))):
                draws = (hmc_phase_draws(k, n, npar) if tag == "hmc"
                         else nuts_phase_draws(k, n, npar, NUTS_DEPTH))
                for i, x in enumerate(draws):
                    out[f"{tag}_draws_p{phase}_{i}_c{c}"] = x
        # A run's moments, for the statistical comparison.
        s = cls(*stack_inputs())
        stat_steps = HMC_STAT_STEPS if tag == "hmc" else NUTS_STAT_STEPS
        ls = s(data, stat_steps, STAT_BF, key=jax.random.PRNGKey(STAT_KEY),
               nchains=STAT_CHAINS)
        out[tag + "_stat_samples"] = ls.samples  # chain-major


def stretch_references(out, data):
    s = j_stretch.StretchSampler(*stack_inputs())
    s.stack.set_data(data)
    rb, dd = s.stack._read_bins, s.stack.device_data
    npar, half = s.nparameters, s.nwalkers // 2
    for c, ek in enumerate(jax.random.split(jax.random.PRNGKey(STRETCH_KEY),
                                            NCHAINS)):
        k_init, k_run = jax.random.split(ek)
        out[f"stretch_init_c{c}"] = np.asarray(
            jax.random.normal(k_init, (s.nwalkers, npar)))
        walkers, wnll = j_stretch.initial_walkers(s, k_init, rb, dd)
        _, (hist, hist_nll, acc) = j_stretch.stretch_segment(
            s, walkers, wnll, rb, dd, k_run, STRETCH_STEPS, False)
        out[f"stretch_hist_c{c}"] = np.asarray(hist)
        out[f"stretch_nll_c{c}"] = j_met.nll_history_to_f64(hist_nll)
        out[f"stretch_accept_c{c}"] = np.asarray(acc)

        def half_draws(k):
            k_z, k_pair, k_acc = jax.random.split(k, 3)
            return (jax.random.uniform(k_z, (half,)),
                    jax.random.randint(k_pair, (half,), 0, half),
                    jax.random.uniform(k_acc, (half,)))

        def step_draws(k):
            k0, k1 = jax.random.split(k)
            return tuple(jnp.stack([a, b]) for a, b in
                         zip(half_draws(k0), half_draws(k1)))

        draws = jax.vmap(step_draws)(jax.random.split(k_run, STRETCH_STEPS))
        for i, x in enumerate(draws):
            out[f"stretch_draws_{i}_c{c}"] = np.asarray(x)
    ls = s(data, STRETCH_STAT_STEPS, STAT_BF,
           key=jax.random.PRNGKey(STAT_KEY), nchains=STAT_CHAINS)
    out["stretch_stat_samples"] = ls.samples  # ensemble-major


def segment_lengths(nsteps, burnin_fraction, seg_steps):
    """The checkpoint runners' segments: (phase, length) in order."""
    burnin = int(nsteps * burnin_fraction)
    bounds = [burnin, 2 * burnin, nsteps] if burnin > 0 else [nsteps]
    total, out = 0, []
    while total < nsteps:
        bound = next(b for b in bounds if total < b)
        n = min(seg_steps, bound - total)
        out.append((bounds.index(bound), n))
        total += n
    return out


def checkpoint_references(out, data):
    segs = segment_lengths(CKPT_STEPS, CKPT_BF, CKPT_SEG)
    npar = 5
    for tag, kw in (("diagonal", {}), ("full_cov", {"proposal": "full_cov"}),
                    ("blocked", {"rate_substeps": CKPT_M})):
        mcmc = j_met.MCMC(*stack_inputs())
        with tempfile.TemporaryDirectory() as work:
            ls = j_ckpt.run_checkpointed(
                mcmc, data, CKPT_STEPS, CKPT_BF, segment_steps=CKPT_SEG,
                checkpoint_path=os.path.join(work, "c.npz"), seed=CKPT_SEED,
                **kw)
        out[f"ckpt_{tag}_samples"] = ls.samples
        out[f"ckpt_{tag}_nll"] = ls.nll_values
        key = jax.random.PRNGKey(CKPT_SEED)
        m = kw.get("rate_substeps", 0)
        for i, (_, n) in enumerate(segs):
            key, seg_key = jax.random.split(key)
            noise, u = j_met._presample(jax.random.split(seg_key, n), npar, m)
            out[f"ckpt_{tag}_noise_s{i}"] = np.asarray(noise)
            out[f"ckpt_{tag}_u_s{i}"] = np.asarray(u)

    tmc = j_tempered.TemperedMCMC(*stack_inputs(), ntemps=NTEMPS, tmax=TMAX,
                                  swap_every=SWAP_EVERY)
    with tempfile.TemporaryDirectory() as work:
        ls = j_ckpt.run_checkpointed_tempered(
            tmc, data, CKPT_STEPS, CKPT_BF, segment_steps=CKPT_SEG,
            checkpoint_path=os.path.join(work, "t.npz"), seed=CKPT_SEED)
    out["ckpt_tempered_samples"] = ls.samples
    out["ckpt_tempered_nll"] = ls.nll_values
    tmc.stack.set_data(data)
    phase_keys = j_tempered._make_tempered_step(
        tmc.mcmc, tmc.stack._read_bins, tmc.stack.device_data, False,
        tuple(float(b) for b in tmc.betas), SWAP_EVERY)[1]
    key = jax.random.PRNGKey(CKPT_SEED)
    for i, (_, n) in enumerate(segs):
        key, seg_key = jax.random.split(key)
        keys_c, k_swap = phase_keys(seg_key, n)
        noise = jax.vmap(jax.vmap(
            lambda k: jax.random.normal(k, (npar,))))(keys_c[:, :, 0])
        u = jax.vmap(jax.vmap(
            lambda k: jax.random.uniform(k, ())))(keys_c[:, :, 1])
        swap_u = jax.vmap(lambda k: jax.random.uniform(k, (NTEMPS,)))(
            k_swap)
        for name, x in (("noise", noise), ("u", u), ("swap_u", swap_u)):
            out[f"ckpt_tempered_{name}_s{i}"] = np.asarray(x)


def main():
    data = make_data(nev=NEV)
    out = {}
    gradient_references(out, data)
    stretch_references(out, data)
    checkpoint_references(out, data)
    np.savez_compressed(os.path.join(HERE, "reference.npz"), **out)


if __name__ == "__main__":
    main()
