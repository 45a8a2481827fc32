"""Carry state from the JAX package to the port.

Takes the numpy arrays a ``sxmc_tpu`` run produced and builds the
port's objects from them, so that both packages can compute on
identical inputs: a chain state, a tempering ladder's or a sharded
ensemble's, the NLL constants, a dataset, a weighted signal's weights,
and presampled noise streams (one chain's or lock-step chains', joint or
blocked, a ladder's, or the sharded ensemble's segments), the draws of
HMC, NUTS and the stretch move, and a checkpointed run's segment draws.
Nothing here imports jax: the caller derives the draws from the JAX keys
of a run as the JAX package does (``tests/data/sampler_reference/
make_reference.py`` shows how) and converts with ``np.asarray`` on its
side; the functions here put them in the port's layout.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.mcmc.metropolis import Presampler
from sxmc_tpu_torch.ops.nll import NLLStatic
from sxmc_tpu_torch.utils import as_f32


def chain_state(params, nll_pair, width, device="cpu"
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                           torch.Tensor]:
    """``(params, (hi, lo), width)`` float32 tensors on ``device``;
    ``width`` may be a full_cov chain's tril ``([nchains,] npar,
    npar)``."""
    hi, lo = (as_f32(np.asarray(x).reshape(()), device) for x in nll_pair)
    return as_f32(params, device), (hi, lo), as_f32(width, device)


def ladder_state(params, nll_pair, width, index: int, device="cpu"):
    """A tempering ladder's state (the carry of the JAX package's
    ``tempered_segment`` / ``_run_tempered``): ``(params (ntemps, npar),
    (hi (ntemps,), lo (ntemps,)), width (ntemps, npar), index)``, the
    index being the swap-interval count (fused route) or the global step
    count (stepper route) that sets the next pairing."""
    hi, lo = (as_f32(np.asarray(x).reshape(-1), device) for x in nll_pair)
    return (as_f32(params, device), (hi, lo), as_f32(width, device),
            int(np.asarray(index)))


def ensemble_state(params, nll_pair, width, device="cpu"):
    """The sharded ensemble's batched chain state (the carry of the JAX
    package's ``_batched_segment[_fused]``): ``(params (nexp, nchains,
    npar), (hi (nexp, nchains), lo (nexp, nchains)), width (nexp,
    nchains, npar))``, or with full_cov the trils ``(nexp, nchains, npar,
    npar)``."""
    params = as_f32(params, device)
    hi, lo = (as_f32(np.asarray(x).reshape(params.shape[:2]), device)
              for x in nll_pair)
    return params, (hi, lo), as_f32(width, device)


def segment_streams(segments, device="cpu"):
    """A sharded-ensemble ``stream_fn`` (``parallel.ensemble``) that
    hands out the given JAX streams: ``segments[(phase, seg)] = (noise,
    u)`` as ``jax.vmap(jax.vmap(_presample))`` over the
    ``_segment_keys`` of that segment gives them, ``(nexp, nchains, n, M
    + 1, npar)`` and ``(nexp, nchains, n, M + 1)``.  They come out in the
    port's grouped layout: ``(n, nexp, nchains, npar)`` for joint steps
    (M = 0), ``(n, M + 1, nexp, nchains, npar)`` for blocked cycles; the
    runner takes ``log(u)`` on the grouped route, ``u`` on the stepper.
    """
    streams = {}
    for key, (noise, u) in segments.items():
        noise = np.asarray(noise, np.float32)
        u = np.asarray(u, np.float32)
        if noise.ndim != 5 or u.shape != noise.shape[:-1]:
            raise ValueError(f"segment {key}: not (nexp, nchains, n, M + 1, "
                             f"npar) streams: noise {noise.shape}, u "
                             f"{u.shape}")
        if noise.shape[3] == 1:  # joint steps
            noise = np.moveaxis(noise[:, :, :, 0], 2, 0)
            u = np.moveaxis(u[:, :, :, 0], 2, 0)
        else:
            noise = np.transpose(noise, (2, 3, 0, 1, 4))
            u = np.transpose(u, (2, 3, 0, 1))
        streams[tuple(key)] = (as_f32(np.ascontiguousarray(noise), device),
                               as_f32(np.ascontiguousarray(u), device))

    def draw(phase: int, seg: int, n: int):
        if (phase, seg) not in streams:
            raise ValueError(f"no stream for segment ({phase}, {seg})")
        noise, u = streams[(phase, seg)]
        if noise.shape[0] != n:
            raise ValueError(f"segment ({phase}, {seg}) stream has "
                             f"{noise.shape[0]} steps, the run asks for {n}")
        return noise, u

    return draw


def weights(histogram) -> Optional[np.ndarray]:
    """A JAX ``EvalHist``'s per-sample weights as float32 numpy, or None
    (the JAX stack reads ``histogram.weights``, which callers may set
    after construction)."""
    w = histogram.weights
    return None if w is None else np.asarray(w, np.float32)


def nll_static(static) -> NLLStatic:
    """An ``NLLStatic`` from the JAX one's fields (numpy copies)."""
    return NLLStatic(
        nexpected=np.asarray(static.nexpected, np.float32),
        n_mc=np.asarray(static.n_mc, np.float32),
        source_id=np.asarray(static.source_id, np.int32),
        means=np.asarray(static.means, np.float32),
        sigmas=np.asarray(static.sigmas, np.float32),
        nsources=int(static.nsources))


def dataset(data) -> np.ndarray:
    """A ``(nevents, nobs + 1)`` float32 dataset (tag last)."""
    data = np.asarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError(f"dataset must be 2-D, got {data.shape}")
    return data


def stream(noise, u, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """A phase's ``(noise, u)`` float32 streams from the JAX package's,
    in the port's layout (``metropolis.presample``).

    One chain: ``_presample(keys, npar, m)`` gives ``(noise (n, m + 1,
    npar), u (n, m + 1))``; with m = 0 (the joint step) that becomes
    ``(n, npar)``, ``(n,)``, and blocked (m > 0) it stays as it is.
    Lock-step chains: ``_run_chains_batched``'s ``phase_xs(ks, n)``
    gives ``(noise (n, nchains, m + 1, npar), u (n, nchains, m + 1))``:
    ``(n, nchains, npar)``, ``(n, nchains)`` for m = 0, and B5's ``(n, m
    + 1, nchains, npar)``, ``(n, m + 1, nchains)`` blocked.  The port's
    routes take what they need from ``u``: the stepper ``u`` itself,
    the fused kernels ``log(u)``.
    """
    noise = np.asarray(noise, np.float32)
    u = np.asarray(u, np.float32)
    if noise.ndim not in (3, 4) or u.shape != noise.shape[:-1]:
        raise ValueError(f"not a _presample / phase_xs stream: noise "
                         f"{noise.shape}, u {u.shape}")
    if noise.shape[-2] == 1:  # joint steps
        noise, u = noise[..., 0, :], u[..., 0]
    elif noise.ndim == 4:  # blocked lock-step chains: m + 1 before chains
        noise = np.ascontiguousarray(np.moveaxis(noise, 1, 2))
        u = np.ascontiguousarray(np.moveaxis(u, 1, 2))
    return as_f32(noise, device), as_f32(u, device)


def presampler(phases: Sequence[Tuple[np.ndarray, np.ndarray]],
               device="cpu") -> Presampler:
    """A presampler that hands out the given JAX ``(noise, u)`` streams
    (see :func:`stream`), one per phase (burn-in 1, burn-in 2, main)."""
    streams = [stream(n, u, device) for n, u in phases]

    def draw(phase: int, n: int):
        noise, u = streams[phase]
        if noise.shape[0] != n:
            raise ValueError(f"phase {phase} stream has {noise.shape[0]} "
                             f"steps, the chain asks for {n}")
        return noise, u

    return draw


def tempered_presampler(phases: Sequence[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]],
                        device="cpu"):
    """A tempered presampler (``mcmc.tempered``) that hands out the given
    per-phase ``(noise (n, ntemps, npar), u (n, ntemps), swap_u (n,
    ntemps))`` streams: burn-in 1, burn-in 2, main (None for a phase
    that does not run)."""
    streams = [None if p is None else tuple(as_f32(x, device) for x in p)
               for p in phases]
    for noise, u, swap_u in filter(None, streams):
        if noise.dim() != 3 or u.shape != noise.shape[:2] \
                or swap_u.shape != u.shape:
            raise ValueError(f"not a ladder's streams: noise "
                             f"{tuple(noise.shape)}, u {tuple(u.shape)}, "
                             f"swap_u {tuple(swap_u.shape)}")

    def draw(phase: int, n: int):
        noise, u, swap_u = streams[phase]
        if noise.shape[0] != n:
            raise ValueError(f"phase {phase} stream has {noise.shape[0]} "
                             f"steps, the ladder asks for {n}")
        return noise, u, swap_u

    return draw


def chains_draws(per_chain: Sequence[Sequence[np.ndarray]]
                 ) -> Tuple[np.ndarray, ...]:
    """One draw tuple per chain, each array ``(n, ...)`` -> one tuple in
    the lock-step layout ``(n, nchains, ...)`` (a single chain is kept
    without the chain axis)."""
    if len(per_chain) == 1:
        return tuple(np.asarray(x) for x in per_chain[0])
    return tuple(np.stack([np.asarray(x) for x in xs], axis=1)
                 for xs in zip(*per_chain))


def draws_presampler(phases, device="cpu"):
    """A presampler of the gradient samplers (``mcmc.hmc``,
    ``mcmc.nuts``) that hands out the given draws of phase 0 (warmup) and
    1 (sampling), each a tuple of arrays with the step as leading axis
    (see :func:`chains_draws`): HMC's ``(momentum normals, accept u)``
    from ``k_mom, k_acc = split(step_key)`` (hmc.py:170-186); NUTS's
    ``(momentum, direction u, merge u, leaf u)``, per level ``k_dir,
    k_sub, k_merge = split(level_key, 3)`` and the leaves from the
    subtree's sequential ``split`` (nuts.py:155-160, 185-187, 199-203,
    256), level d's 2^d leaves at offset 2^d - 1."""
    streams = [tuple(as_f32(x, device) for x in p) for p in phases]

    def draw(phase: int, n: int):
        if streams[phase][0].shape[0] != n:
            raise ValueError(f"phase {phase} draws have "
                             f"{streams[phase][0].shape[0]} steps, the "
                             f"chain asks for {n}")
        return streams[phase]

    return draw


def stretch_presampler(z_u, pick, acc_u, device="cpu"):
    """A stretch presampler (``mcmc.stretch``) that hands out the given
    draws, ``(n, 2, [nchains,] half)`` each: per half-move ``k_z,
    k_pair, k_acc = split(k, 3)`` of ``k0, k1 = split(step_key)``
    (stretch.py:132-137, 150-152) give the z uniforms, the partner
    indices and the accept uniforms."""
    z_u, acc_u = as_f32(z_u, device), as_f32(acc_u, device)
    pick = torch.as_tensor(np.asarray(pick, np.int64), device=device)

    def draw(n: int):
        if z_u.shape[0] != n:
            raise ValueError(f"the draws have {z_u.shape[0]} steps, the "
                             f"ensemble asks for {n}")
        return z_u, pick, acc_u

    return draw


def segment_draws(segments, device="cpu"):
    """A checkpoint runner's ``stream_fn`` (``checkpoint``) that hands out
    ``segments[i]``, a tuple of arrays, as the draws of the run's i-th
    segment (whatever its phase): for Metropolis :func:`stream`'s ``(noise,
    u)`` of the JAX package's per-segment ``_presample``, for a ladder
    ``(noise, u, swap_u)``; the JAX runners take segment i's key from the
    chain ``key, seg_key = split(key)`` (checkpoint.py:112, 418)."""
    streams = [tuple(as_f32(x, device) for x in seg) for seg in segments]

    def draw(phase: int, seg: int, n: int):
        if seg >= len(streams) or streams[seg][0].shape[0] != n:
            raise ValueError(f"no draws of {n} steps for segment {seg}")
        return streams[seg]

    return draw
