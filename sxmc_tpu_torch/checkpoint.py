"""Mid-chain checkpoint / resume for every sampler (port of
``sxmc_tpu/checkpoint.py``).

The reference resumes only whole experiments (the ``fit.samples`` file,
sxmc.cpp:84-94).  Here a chain runs in fixed-size segments, and after
each one its whole state (parameters, NLL pairs, jump widths or the
full_cov tril, the dual-averaging state of HMC and NUTS, the walkers of
the stretch ensemble, the tempering ladder, the kept samples) is written
atomically, so that a killed fit resumes where it stopped.

Each segment's draws come from a ``torch.Generator`` seeded by ``(seed,
phase, segment)`` (``utils.segment_seed``, as the sharded ensemble's),
and the state file records the position ``(segment)`` in place of the
JAX package's PRNG key: a resumed fit reproduces the uninterrupted
checkpointed fit bit for bit.  A caller may inject the draws instead
(``stream_fn(phase, segment, n)``; the tests feed the JAX package's
segment streams).  The other keys of the JAX package's state files are
kept, but a file written by one package does not load in the other (the
position is a segment count here, a PRNG key there).  A file whose
``seed`` is not the run's is not resumed: the run starts afresh.

Each runner runs one chain, as the JAX package's do: Metropolis (one
whole-segment kernel launch a segment on the fused route, B4 diagonal or
tril, or B5 for ``rate_substeps``; the stepper otherwise), the
tempering ladder, HMC and NUTS, and one stretch ensemble.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace
from sxmc_tpu_torch.utils import as_f32, segment_seed

# (phase, segment, nsteps) -> the segment's draws, as the sampler's
# presampler hands them out for one chain.
StreamFn = Callable[[int, int, int], tuple]


def save_chain_state(path: str, state: dict) -> None:
    """Write ``state`` to ``path`` atomically (a temporary file, then
    ``os.replace``)."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state)
    os.replace(tmp, path)


def load_chain_state(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.keys()}


def _resume(path: str, seed: int) -> Optional[dict]:
    state = load_chain_state(path)
    if state is not None and int(state["seed"]) != seed:
        return None
    return state


def _check_burnin(nsteps: int, burnin_steps: int,
                  debug_mode: bool) -> None:
    if burnin_steps > 0 and nsteps <= 2 * burnin_steps \
            and not debug_mode:
        raise ValueError(
            f"nsteps={nsteps} leaves no post-burn-in samples (two "
            f"burn-in phases of {burnin_steps}); lower burnin_fraction "
            f"below 0.5 or raise nsteps")


def segment_generator(seed: int, phase: int, seg: int,
                      device) -> torch.Generator:
    """The generator of one segment's draws."""
    return torch.Generator(device).manual_seed(segment_seed(seed, phase,
                                                            seg))


def _t(state: dict, key: str, device) -> torch.Tensor:
    return as_f32(state[key], device)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _report(verbose: bool, what: str, total: int, nsteps: int, path: str,
            extra: str = "") -> None:
    if verbose:
        print(f"checkpoint{what}: step {total}/{nsteps}{extra} -> {path}")


def run_checkpointed(
    mcmc: MCMC,
    data,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 5000,
    checkpoint_path: str = "chain.ckpt.npz",
    debug_mode: bool = False,
    seed: int = 0,
    verbose: bool = False,
    rate_substeps: int = 0,
    proposal: str = "diagonal",
    stream_fn: Optional[StreamFn] = None,
) -> LikelihoodSpace:
    """One Metropolis chain with a checkpoint after every segment
    (checkpoint.py:48-165).  Semantics of ``MCMC.__call__``: two burn-in
    phases of ``nsteps * burnin_fraction`` steps, each ending in a
    retune (RMS widths, or with ``proposal="full_cov"`` the Haario
    tril), then the main phase; only its samples are kept (debug: all).
    Every segment is one :func:`metropolis.run_segment`; its draws ``(noise
    (n, [M + 1,] npar), u)`` come from ``stream_fn`` or from
    :func:`segment_generator`.  ``mcmc.last_accept_rate`` becomes the
    mean acceptance of the kept steps."""
    metropolis.check_proposal(proposal, rate_substeps)
    full_cov = proposal == "full_cov"
    dev = mcmc.device
    npar = mcmc.nparameters
    mcmc.stack.set_data(data)
    rb = mcmc.stack.read_bins
    burnin_steps = int(nsteps * burnin_fraction)
    _check_burnin(nsteps, burnin_steps, debug_mode)
    m = rate_substeps if metropolis._blocked_enabled(mcmc,
                                                    rate_substeps) else 0
    if stream_fn is None:
        def stream_fn(phase, seg, n):
            return metropolis.presample(
                segment_generator(seed, phase, seg, dev), n, npar, dev, 1, m)

    state = _resume(checkpoint_path, seed)
    if state is None:
        params, (hi, lo), width = metropolis.initial_state(mcmc, rb)
        if full_cov:
            width = metropolis._initial_scale_tril(mcmc)
        state = {
            "params": _np(params), "nll_hi": _np(hi), "nll_lo": _np(lo),
            "width": _np(width), "seed": np.int64(seed),
            "segment": np.int64(0), "step": np.int64(0),
            "kept": np.zeros((0, npar), np.float32),
            "kept_nll": np.zeros((0,), np.float64),
            "phase_samples": np.zeros((0, npar), np.float32),
            "acc_sum": np.float64(0.0),
        }
    total = int(state["step"])
    phase_bounds = ([burnin_steps, 2 * burnin_steps, nsteps]
                    if burnin_steps > 0 else [nsteps])
    retune = (metropolis.retune_scale_tril if full_cov
              else metropolis.retune_width)

    while total < nsteps:
        bound = next(b for b in phase_bounds if total < b)
        n = min(segment_steps, bound - total)
        phase = (phase_bounds.index(bound) if burnin_steps > 0 else 2)
        seg = int(state["segment"])
        noise, u = stream_fn(phase, seg, n)
        params, (hi, lo), samples, nlls, accs = metropolis.run_segment(
            mcmc, _t(state, "params", dev),
            (_t(state, "nll_hi", dev), _t(state, "nll_lo", dev)),
            _t(state, "width", dev), rb, noise, u, debug_mode,
            rate_substeps, proposal)
        samples = _np(samples)
        nlls = metropolis.nll_history_to_f64(nlls)
        in_burnin = bound != nsteps
        if in_burnin:
            state["phase_samples"] = np.concatenate(
                [state["phase_samples"], samples])
        if debug_mode or not in_burnin:
            state["kept"] = np.concatenate([state["kept"], samples])
            state["kept_nll"] = np.concatenate([state["kept_nll"], nlls])
            state["acc_sum"] = np.float64(state["acc_sum"]
                                          + float(accs.sum()))
        total += n
        width = state["width"]
        if in_burnin and total == bound:
            # Phase end: retune from the phase's samples (mcmc.cpp:
            # 273-311), RMS widths or the Haario tril.
            width = _np(retune(mcmc, as_f32(width, dev),
                               as_f32(state["phase_samples"], dev)))
            state["phase_samples"] = np.zeros((0, npar), np.float32)
        state.update({"params": _np(params), "nll_hi": _np(hi),
                      "nll_lo": _np(lo), "width": width,
                      "segment": np.int64(seg + 1),
                      "step": np.int64(total)})
        save_chain_state(checkpoint_path, state)
        _report(verbose, "", total, nsteps, checkpoint_path,
                f" (accept {float(accs.mean()):.2f})")

    mcmc.last_accept_rate = float(state["acc_sum"]) / max(
        len(state["kept"]), 1)
    return LikelihoodSpace.from_arrays(state["kept"], state["kept_nll"],
                                       mcmc.parameter_names)


def run_checkpointed_tempered(
    sampler,
    data,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 5000,
    checkpoint_path: str = "chain.ckpt.npz",
    debug_mode: bool = False,
    seed: int = 0,
    verbose: bool = False,
    stream_fn: Optional[StreamFn] = None,
) -> LikelihoodSpace:
    """The tempering ladder (a ``mcmc.tempered.TemperedMCMC``) with a
    checkpoint after every segment (checkpoint.py:353-463): the state is
    the whole ladder plus the global step count, which sets the swap
    cadence and the pairing, so that a resumed run swaps on exactly the
    schedule of the uninterrupted one.  Segments run on the route
    ``run_tempered`` takes for the stack (``tempered.tempered_segment``);
    their draws ``(noise (n, ntemps, npar), u, swap_u (n, ntemps))``
    come from ``stream_fn`` or :func:`segment_generator`.  After each
    burn-in phase every replica takes the cold chain's RMS retune."""
    from sxmc_tpu_torch.mcmc import tempered

    mcmc = sampler.mcmc
    dev = mcmc.device
    betas = tuple(float(b) for b in sampler.betas)
    ntemps = len(betas)
    npar = mcmc.nparameters
    mcmc.stack.set_data(data)
    rb = mcmc.stack.read_bins
    burnin_steps = int(nsteps * burnin_fraction)
    _check_burnin(nsteps, burnin_steps, debug_mode)
    if stream_fn is None:
        def stream_fn(phase, seg, n):
            return tempered.presample_tempered(
                segment_generator(seed, phase, seg, dev), n, ntemps, npar,
                dev)

    state = _resume(checkpoint_path, seed)
    if state is None:
        params = torch.as_tensor(mcmc.parameter_means, device=dev).expand(
            ntemps, npar).contiguous()
        width = np.broadcast_to(mcmc.initial_jump_widths(),
                                (ntemps, npar)).copy()
        hi, lo = metropolis._chain_nll(mcmc, rb, allow_fused=False)(params)
        state = {
            "params": _np(params), "nll_hi": _np(hi), "nll_lo": _np(lo),
            "width": width, "seed": np.int64(seed),
            "segment": np.int64(0), "step": np.int64(0),
            "kept": np.zeros((0, npar), np.float32),
            "kept_nll": np.zeros((0,), np.float64),
            "phase_samples": np.zeros((0, npar), np.float32),
            "acc_sum": np.float64(0.0), "swap_sum": np.float64(0.0),
            "swap_att": np.float64(0.0),
        }
    total = int(state["step"])
    phase_bounds = ([burnin_steps, 2 * burnin_steps, nsteps]
                    if burnin_steps > 0 else [nsteps])
    run = tempered.make_tempered_segment(mcmc, rb, debug_mode, betas,
                                         sampler.swap_every)

    while total < nsteps:
        bound = next(b for b in phase_bounds if total < b)
        n = min(segment_steps, bound - total)
        phase = (phase_bounds.index(bound) if burnin_steps > 0 else 2)
        seg = int(state["segment"])
        noise, u, swap_u = stream_fn(phase, seg, n)
        params, (hi, lo), _, samples, nlls, accs, (frac, att) = \
            tempered.tempered_segment(
                mcmc, _t(state, "params", dev),
                (_t(state, "nll_hi", dev), _t(state, "nll_lo", dev)),
                _t(state, "width", dev), total, rb, noise, u, swap_u,
                debug_mode, betas, sampler.swap_every, run)
        samples = _np(samples)
        nlls = metropolis.nll_history_to_f64(nlls)
        in_burnin = bound != nsteps
        if in_burnin:
            state["phase_samples"] = np.concatenate(
                [state["phase_samples"], samples])
        if debug_mode or not in_burnin:
            state["kept"] = np.concatenate([state["kept"], samples])
            state["kept_nll"] = np.concatenate([state["kept_nll"], nlls])
            state["acc_sum"] = np.float64(state["acc_sum"]
                                          + float(accs.sum()))
        state["swap_sum"] = np.float64(state["swap_sum"] + float(frac.sum()))
        state["swap_att"] = np.float64(state["swap_att"] + float(att.sum()))
        total += n
        width = state["width"]
        if in_burnin and total == bound:
            # The cold chain's RMS retune, shared down the ladder.
            width = _np(metropolis.retune_width(
                mcmc, as_f32(width, dev),
                as_f32(state["phase_samples"], dev)))
            state["phase_samples"] = np.zeros((0, npar), np.float32)
        state.update({"params": _np(params), "nll_hi": _np(hi),
                      "nll_lo": _np(lo), "width": width,
                      "segment": np.int64(seg + 1),
                      "step": np.int64(total)})
        save_chain_state(checkpoint_path, state)
        _report(verbose, "(tempered)", total, nsteps, checkpoint_path,
                f" (accept {float(accs.mean()):.2f})")

    sampler.last_accept_rate = float(state["acc_sum"]) / max(
        len(state["kept"]), 1)
    sampler.last_swap_rate = float(state["swap_sum"]) / max(
        float(state["swap_att"]), 1.0)
    return LikelihoodSpace.from_arrays(state["kept"], state["kept_nll"],
                                       mcmc.parameter_names)


_WARM_KEYS = ("q", "u", "log_eps", "log_eps_bar", "h_bar", "t")


def run_checkpointed_hmc(
    hmc,
    data,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 2000,
    checkpoint_path: str = "hmc.ckpt.npz",
    seed: int = 0,
    verbose: bool = False,
    stream_fn: Optional[StreamFn] = None,
) -> LikelihoodSpace:
    """HMC, or NUTS (a ``mcmc.nuts.NUTS``: the same machinery dispatches
    on the sampler), with a checkpoint after every segment
    (checkpoint.py:247-350): the dual-averaging warmup, then sampling at
    the adapted step size and mass, both in segments (phase 0 warmup,
    phase 1 sampling).  The draws come from ``stream_fn`` or
    :func:`segment_generator` (``hmc.presample``)."""
    from sxmc_tpu_torch.mcmc import hmc as hmc_mod

    dev = hmc.device
    npar = hmc.nparameters
    hmc.stack.set_data(data)
    rb = hmc.stack.read_bins
    warmup, keep = hmc_mod.warmup_keep(nsteps, burnin_fraction)
    total = warmup + keep
    fns = hmc._fns(rb)
    if stream_fn is None:
        def stream_fn(phase, seg, n):
            return hmc.presample(segment_generator(seed, phase, seg, dev), n)

    state = _resume(checkpoint_path, seed)
    if state is None:
        carry = hmc_mod.initial_warm_carry(hmc, rb, fns)
        state = {k: _np(v) for k, v in zip(_WARM_KEYS, carry)}
        state.update({
            "eps": np.float32(0.0), "inv_mass": np.zeros(npar, np.float32),
            "seed": np.int64(seed), "segment": np.int64(0),
            "step": np.int64(0),
            "warm_qs": np.zeros((0, npar), np.float32),
            "kept": np.zeros((0, npar), np.float32),
            "kept_nll": np.zeros((0,), np.float32),
            "acc_sum": np.float64(0.0),
        })
    done = int(state["step"])
    while done < total:
        in_warm = done < warmup
        n = min(segment_steps, (warmup if in_warm else total) - done)
        seg = int(state["segment"])
        draws = stream_fn(0 if in_warm else 1, seg, n)
        if in_warm:
            carry, warm_qs = hmc_mod.warmup_segment(
                hmc, tuple(_t(state, k, dev) for k in _WARM_KEYS), rb, draws,
                fns)
            state.update({k: _np(v) for k, v in zip(_WARM_KEYS, carry)})
            state["warm_qs"] = np.concatenate([state["warm_qs"],
                                               _np(warm_qs)])
            if done + n == warmup:
                state["eps"] = _np(torch.exp(carry[3]))
                state["inv_mass"] = _np(hmc_mod.mass_from_warmup(
                    hmc, as_f32(state["warm_qs"], dev)))
        else:
            (q, u_q), (samples, nlls, accs) = hmc_mod.main_segment(
                hmc, _t(state, "q", dev), _t(state, "u", dev),
                _t(state, "eps", dev), _t(state, "inv_mass", dev), rb,
                draws, fns)
            state.update({
                "q": _np(q), "u": _np(u_q),
                "kept": np.concatenate([state["kept"], _np(samples)]),
                "kept_nll": np.concatenate([state["kept_nll"], _np(nlls)]),
                "acc_sum": np.float64(state["acc_sum"] + float(accs.sum())),
            })
        done += n
        state.update({"segment": np.int64(seg + 1), "step": np.int64(done)})
        save_chain_state(checkpoint_path, state)
        _report(verbose, "(hmc)", done, total, checkpoint_path,
                " (warmup)" if in_warm else "")

    hmc.last_accept_rate = float(state["acc_sum"]) / max(
        len(state["kept"]), 1)
    hmc.last_evaluations = fns.evaluations
    return LikelihoodSpace.from_arrays(state["kept"], state["kept_nll"],
                                       hmc.parameter_names)


def run_checkpointed_stretch(
    sampler,
    data,
    nsteps: int,
    burnin_fraction: float = 0.1,
    segment_steps: int = 2000,
    checkpoint_path: str = "stretch.ckpt.npz",
    debug_mode: bool = False,
    seed: int = 0,
    verbose: bool = False,
    stream_fn: Optional[StreamFn] = None,
    init_noise: Optional[torch.Tensor] = None,
) -> LikelihoodSpace:
    """One stretch ensemble with a checkpoint after every segment
    (checkpoint.py:168-245): the first ``nsteps * burnin_fraction`` steps
    dropped, the rest pooled over the walkers.  The draws come from
    ``stream_fn`` (phase 0) or :func:`segment_generator`, the initial
    cloud from ``init_noise`` or the generator of phase -1."""
    from sxmc_tpu_torch.mcmc import stretch

    dev = sampler.device
    npar = sampler.nparameters
    sampler.stack.set_data(data)
    rb = sampler.stack.read_bins
    burnin = int(nsteps * burnin_fraction)
    nll_batch = metropolis._chain_nll(sampler, rb, allow_fused=False)
    if stream_fn is None:
        def stream_fn(phase, seg, n):
            return stretch.presample(
                sampler, segment_generator(seed, phase, seg, dev), n)

    state = _resume(checkpoint_path, seed)
    if state is None:
        if init_noise is None:
            init_noise = stretch.walker_noise(
                sampler, segment_generator(seed, -1, 0, dev))
        walkers, (hi, lo) = stretch.initial_walkers(sampler, init_noise, rb,
                                                    nll_batch)
        state = {
            "walkers": _np(walkers), "wnll_hi": _np(hi),
            "wnll_lo": _np(lo), "seed": np.int64(seed),
            "segment": np.int64(0), "step": np.int64(0),
            "kept": np.zeros((0, npar), np.float32),
            "kept_nll": np.zeros((0,), np.float64),
            "acc_sum": np.float64(0.0),
        }
    total = int(state["step"])
    while total < nsteps:
        n = min(segment_steps, nsteps - total)
        seg = int(state["segment"])
        (walkers, (hi, lo)), (hist, (h_hi, h_lo), acc) = \
            stretch.stretch_segment(
                sampler, _t(state, "walkers", dev),
                (_t(state, "wnll_hi", dev), _t(state, "wnll_lo", dev)), rb,
                stream_fn(0, seg, n), debug_mode, nll_batch)
        first = max(burnin - total, 0)
        if first < n:
            state["kept"] = np.concatenate(
                [state["kept"], _np(hist[first:]).reshape(-1, npar)])
            state["kept_nll"] = np.concatenate(
                [state["kept_nll"], metropolis.nll_history_to_f64(
                    (h_hi[first:], h_lo[first:])).reshape(-1)])
        total += n
        state.update({"walkers": _np(walkers), "wnll_hi": _np(hi),
                      "wnll_lo": _np(lo), "segment": np.int64(seg + 1),
                      "step": np.int64(total),
                      "acc_sum": np.float64(state["acc_sum"]
                                            + float(acc) * n)})
        save_chain_state(checkpoint_path, state)
        _report(verbose, "(stretch)", total, nsteps, checkpoint_path,
                f" (accept {float(acc):.2f})")

    sampler.last_accept_rate = float(state["acc_sum"]) / max(nsteps, 1)
    return LikelihoodSpace.from_arrays(state["kept"], state["kept_nll"],
                                       sampler.parameter_names)
