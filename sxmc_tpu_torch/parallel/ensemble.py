"""Sharded ensemble: every fake experiment's chains as one batch.

Port of ``sxmc_tpu/parallel/ensemble.py``.  It replaces the reference's
serial experiment loop (sxmc.cpp:59-145): all ``nexperiments`` datasets
are drawn and padded to a common event count (pad rows have zero
coordinates and the dataset tag ``PAD_TAG``, which no signal uses, so
every read bin of theirs is a sentinel: -1 where zero lies outside the
domain, else -2; either adds exactly 0 to the NLL), and the chains of
all experiments run as one batch of ``nexp x nchains``.

Placement: without a mesh the batch runs on the one device it is given
(the JAX package's 1 x 1 mesh).  With ``mesh=`` (``parallel.mesh``:
``exp`` and ``chain`` axes) the batch is split into the mesh's ``{exp,
chain}`` blocks when they divide it (the JAX package's
``_fused_route_ok``), and each block runs its segments on its own device
from the same streams; the histories are gathered to the mesh's first
device.  A chain walks the same in any block (the experiment-grouped
kernels and the plain versions compute each chain on its own, and the
burn-in moments of its retunes are summed on the host in one order per
chain), so a sharded run equals the one-device batch.

Routes, as the JAX package chooses them (``_fused_route_ok``):
  * **grouped**: floating systematics, the unbinned likelihood, and (for
    ``rate_substeps``) an unweighted stack.  Each phase is one launch of
    the experiment-grouped whole-segment kernel (B4, diagonal or tril,
    unweighted or weighted; B5 for blocked cycles): chain c reads
    experiment c // nchains's read bins and every chain shares each
    read of the MC samples.  A batch past one launch's chain caps goes
    out in launches of whole experiments (``ops.kernels``).
  * **per experiment**: the other stacks (fixed systematics, binned
    fits, weighted blocked fits) and debug mode run experiment by
    experiment through ``mcmc.metropolis.run_chain`` on that
    experiment's read bins (the JAX package's vmapped
    ``_run_single_chain``), or ``run_segment`` when checkpointing.

The initial state of each experiment comes from
``metropolis.initial_state`` on its read bins: one B3 launch per
experiment on the grouped route (the JAX package takes the split path
here, B1 + B2; the NLLs agree to rounding).

Checkpointing (``checkpoint_steps > 0`` with a ``checkpoint_path``
prefix): the walk runs in fixed-size segments and the whole batched
state (parameters, NLL pairs, widths or trils, the running phase
moments the retunes need) is written atomically to
``<path>.state.npz`` after every segment, the sampling segments' history
to ``<path>.p{phase}s{seg}.npz``.  ``resume=True`` continues a killed
run from its last completed segment, bit for bit: the datasets come
from ``fc.seed`` and the experiment index, and each segment's streams
from a ``torch.Generator`` seeded from ``(fc.seed, phase, segment)``.

Differences from the JAX package: the streams are the port's own (the
tests inject the JAX ones through ``stream_fn``, see
``interop.segment_streams``); ``fit.binned`` is honoured (the JAX
runner builds its MCMC without it and fits unbinned; the two
likelihoods are equal, the binned one an exact regrouping).

KDE stacks run experiment by experiment (they take no fused kernel);
``kde_exact`` rows read each experiment's own padded events (pad rows
carry a tag no signal has: 0, or NaN out of domain, and either adds 0
to the NLL), as the JAX package's per-experiment extras do
(ensemble.py:310-327, 377-398); segment checkpointing refuses them, as
the JAX package does (:447-452).
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.ensemble import experiment_seeds
from sxmc_tpu_torch.fitconfig import FitConfig
from sxmc_tpu_torch.generator import make_fake_dataset
from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.metropolis import HAARIO, MCMC
from sxmc_tpu_torch.observability import MetricsLogger, Stopwatch
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.mesh import Mesh
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace
from sxmc_tpu_torch.utils import (as_f32, median, resolve_device,
                                  segment_seed)

PAD_TAG = -999.0  # dataset tag no signal uses: sentinel read bins

# (phase, segment, nsteps) -> (noise (n, [M + 1,] nexp, nchains, npar),
# u (n, [M + 1,] nexp, nchains)) float32, u ~ U[0, 1).
StreamFn = Callable[[int, int, int], Tuple[torch.Tensor, torch.Tensor]]


def pad_datasets(datasets: Sequence[np.ndarray],
                 nevents: Optional[int] = None) -> np.ndarray:
    """Stack ragged datasets into (nexp, nevents, ncols) with pad rows."""
    if nevents is None:
        nevents = max(d.shape[0] for d in datasets)
    ncols = datasets[0].shape[1]
    out = np.zeros((len(datasets), nevents, ncols), np.float32)
    out[:, :, -1] = PAD_TAG
    for i, d in enumerate(datasets):
        out[i, :d.shape[0]] = d[:nevents]
    return out


def default_streams(seed: int, nexp: int, nchains: int, npar: int, m: int,
                    device) -> StreamFn:
    """The port's segment streams: drawn on ``device`` from a
    ``torch.Generator`` seeded by :func:`segment_seed`, in the grouped
    layout (``M + 1`` axis for blocked cycles, row 0 the systematic
    move)."""

    def draw(phase: int, seg: int, n: int):
        gen = torch.Generator(device).manual_seed(
            segment_seed(seed, phase, seg))
        noise, u = metropolis.presample(gen, n, npar, device,
                                        nexp * nchains, m)
        lead = (n,) + ((m + 1,) if m else ()) + (nexp, nchains)
        return noise.reshape(lead + (npar,)), u.reshape(lead)

    return draw


def _sharded_retune(mcmc: MCMC, width, count, psum, psumsq):
    """Batched jump-width retune from running phase moments: the
    population std sqrt(E[x^2] - E[x]^2), so a checkpoint carries
    (count, sum, sumsq) instead of the phase history (JAX
    ensemble.py:196-210)."""
    mean = psum / count
    var = torch.clamp_min(psumsq / count - mean * mean, 0.0)
    rms = torch.sqrt(var)
    sf = HAARIO / max(mcmc.nfloat, 1)
    fixed = torch.as_tensor(mcmc.parameter_fixed, device=width.device)
    new = torch.where(rms > 0, sf * rms, width)
    return torch.where(fixed, torch.full_like(new, -1.0), new)


def _sharded_retune_cov(mcmc: MCMC, tril, count, psum, pcross):
    """Batched Haario full-covariance retune from running CENTERED
    phase moments (JAX ensemble.py:213-230): ``psum`` / ``pcross``
    accumulate (x - c) and (x - c)(x - c)^T around the phase-start point
    c, so the one-pass covariance (pcross - n mu mu^T) / (n - 1) keeps
    its precision in float32; then ``metropolis._tril_from_cov`` per
    chain."""
    free = torch.as_tensor(~mcmc.parameter_fixed, dtype=torch.float32,
                           device=tril.device)
    mu = psum / count
    cov = ((pcross - count * mu[..., :, None] * mu[..., None, :])
           / torch.clamp_min(count - 1.0, 1.0))
    cov = cov * (free[:, None] * free[None, :])
    return metropolis._tril_from_cov(mcmc, tril, cov)


def _fused_route_ok(mcmc: MCMC, rate_substeps: int) -> bool:
    """True when the runner can drive the experiment-grouped kernels: a
    fused-eligible stack, and for blocked cycles B5's unweighted stack
    (JAX ensemble.py:233-246; its mesh divisibility holds on one
    device)."""
    if metropolis._blocked_enabled(mcmc, rate_substeps):
        return metropolis._blocked_fused_ok(mcmc)
    return metropolis._fused_ok(mcmc)


def draw_datasets(fc: FitConfig, stack, experiments: Sequence[int],
                  dataset_fn: Optional[Callable[[int], np.ndarray]] = None,
                  poisson: bool = True) -> List[np.ndarray]:
    """The datasets of global experiments ``experiments``: experiment
    i's is the one ``run_ensemble`` draws for it (its first attempt's
    data seed; ``poisson=False`` takes every expected count exactly), or
    ``dataset_fn(i)``."""
    datasets = []
    for i in experiments:
        if dataset_fn is not None:
            datasets.append(np.asarray(dataset_fn(i), np.float32))
            continue
        data_seed, _ = experiment_seeds(fc.seed, i, 0)
        datasets.append(make_fake_dataset(
            torch.Generator().manual_seed(data_seed), fc.signals,
            fc.systematics, fc.observables, stack=stack, poisson=poisson))
    return datasets


def _ensemble_setup(fc: FitConfig, nsteps: int, device,
                    dataset_fn: Optional[Callable[[int], np.ndarray]]):
    """Model, read bins ``(nexp, nsignals, nevents)`` of the padded
    datasets (:func:`draw_datasets`), and the padded datasets: a pure
    function of the FitConfig, so a resumed run rebuilds them
    identically."""
    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                device=device, binned=fc.binned)
    batch = pad_datasets(draw_datasets(fc, mcmc.stack,
                                       range(fc.nexperiments), dataset_fn))
    rb = mcmc.stack.compute_read_bins(batch)
    return (mcmc, rb, batch, max(fc.nchains, 1),
            int(nsteps * fc.burnin_fraction))


def _initial_batch(mcmc: MCMC, rb: torch.Tensor, nchains: int,
                   full_cov: bool):
    """``(params, (hi, lo), width)`` of the ``(nexp, nchains)`` batch:
    every chain at the means with the initial widths (or the initial
    diagonal tril), and each experiment's NLL there from
    ``metropolis.initial_state`` on its read bins (B3 on the fused
    route; B1, and B2 with fixed systematics, otherwise)."""
    nexp = rb.shape[0]
    npar = mcmc.nparameters
    starts = [metropolis.initial_state(mcmc, rb[e]) for e in range(nexp)]
    lead = (nexp, nchains)

    def batch(x):  # (nexp, ...) per experiment -> (nexp, nchains, ...)
        return x[:, None].expand(lead + tuple(x.shape[1:])).contiguous()

    params = batch(starts[0][0].expand(nexp, npar))
    hi = batch(torch.stack([s[1][0] for s in starts]))
    lo = batch(torch.stack([s[1][1] for s in starts]))
    if full_cov:
        width = batch(metropolis._initial_scale_tril(mcmc).expand(
            nexp, npar, npar))
    else:
        width = batch(starts[0][2].expand(nexp, npar))
    return params, (hi, lo), width


def _segment(mcmc: MCMC, params, nll_pair, width, rb, noise, u,
             debug_mode: bool, m: int, full_cov: bool, grouped: bool):
    """One fixed-proposal segment of the ``(nexp, nchains)`` batch.

    Grouped: one call of the stack's grouped kernel (B5 for ``m``
    blocked rate moves, B4-tril for ``full_cov``, else B4) on ``log(u)``.
    Otherwise experiment by experiment through
    ``metropolis.run_segment`` (lock-step chains on that experiment's
    read bins, the stepper's accept on ``u``).  Returns ``(params, (hi,
    lo), samples (nexp, nchains, n, npar), (hi, lo) (nexp, nchains,
    n))``."""
    if grouped:
        stack = mcmc.stack
        if m:
            run = stack.blocked_segment_grouped
        elif full_cov:
            run = stack.fused_segment_tril_grouped
        else:
            run = stack.fused_segment_grouped
        samples, nlls, _ = run(params, torch.stack(nll_pair, dim=-1), width,
                               rb, noise, torch.log(u), mcmc.nll_spec,
                               debug_mode)
        # Contiguous histories: torch's sum over the steps of a strided
        # view takes an order that depends on the batch's size, and a
        # chain's moments must not depend on the chains beside it.
        samples = samples.movedim(0, 2).contiguous()
        hi = nlls[..., 0].movedim(0, 2).contiguous()
        lo = nlls[..., 1].movedim(0, 2).contiguous()
        return (samples[:, :, -1].contiguous(),
                (hi[:, :, -1].contiguous(), lo[:, :, -1].contiguous()),
                samples, (hi, lo))
    proposal = "full_cov" if full_cov else "diagonal"
    outs = []
    for e in range(rb.shape[0]):
        outs.append(metropolis.run_segment(
            mcmc, params[e], (nll_pair[0][e], nll_pair[1][e]), width[e],
            rb[e], noise[..., e, :, :].contiguous(),
            u[..., e, :].contiguous(), debug_mode, m, proposal))
    # run_segment's histories are (n, nchains, ...): chains first here.
    return (torch.stack([o[0] for o in outs]),
            (torch.stack([o[1][0] for o in outs]),
             torch.stack([o[1][1] for o in outs])),
            torch.stack([o[2].movedim(0, 1) for o in outs]),
            (torch.stack([o[3][0].movedim(0, 1) for o in outs]),
             torch.stack([o[3][1].movedim(0, 1) for o in outs])))


class _Shard(NamedTuple):
    """One ``{exp, chain}`` block of the batch: the model on its device
    and the experiments and chains it holds."""

    mcmc: MCMC
    exps: Tuple[int, int]
    chains: Tuple[int, int]


def _shards(fc: FitConfig, mcmc: MCMC, mesh: Optional[Mesh], nexp: int,
            nchains: int) -> List[_Shard]:
    """The batch's blocks: one on ``mcmc``'s device without a mesh, or
    when the mesh's ``exp`` and ``chain`` sizes do not divide the batch
    (the JAX package then leaves the batch unsplit too); else the
    mesh's ``{exp, chain}`` blocks in order (exp-major), each with a
    model on its shard's device (one per distinct device)."""
    whole = [_Shard(mcmc, (0, nexp), (0, nchains))]
    if mesh is None:
        return whole
    ne, nc = mesh.shape.get("exp", 1), mesh.shape.get("chain", 1)
    if nexp % ne or nchains % nc:
        return whole
    models = {mcmc.device: mcmc}
    out = []
    for i, eb in enumerate(mesh_lib.blocks(nexp, ne)):
        for j, cb in enumerate(mesh_lib.blocks(nchains, nc)):
            idx = tuple({"exp": i, "chain": j}.get(a, 0)
                        for a in mesh.axis_names)
            dev = mesh.devices[idx]
            if dev not in models:
                models[dev] = MCMC(fc.sources, fc.signals, fc.systematics,
                                   fc.observables, device=dev,
                                   binned=fc.binned)
            out.append(_Shard(models[dev], eb, cb))
    return out


def _gather(parts: Sequence, shards: Sequence[_Shard], device):
    """Reassemble the shards' outputs (each a nest of tuples of tensors
    with leading ``(exps, chains)`` axes) on ``device``: chain blocks
    side by side, then experiment blocks."""
    first = parts[0]
    if isinstance(first, tuple):
        return tuple(_gather([p[k] for p in parts], shards, device)
                     for k in range(len(first)))
    rows, row, cur = [], [], shards[0].exps
    for p, sh in zip(parts, shards):
        if sh.exps != cur:
            rows.append(torch.cat(row, dim=1))
            row, cur = [], sh.exps
        row.append(p.to(device))
    rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)


def _sharded_segment(shards: Sequence[_Shard], params, nll_pair, width, rb,
                     noise, u, debug_mode: bool, m: int, full_cov: bool,
                     grouped: bool):
    """:func:`_segment` on every shard's block, on its device, the
    results gathered on the device of ``params``.  The shards are issued
    in turn from this thread; on distinct cards their launches overlap
    until the gather."""
    if len(shards) == 1:
        return _segment(shards[0].mcmc, params, nll_pair, width, rb, noise,
                        u, debug_mode, m, full_cov, grouped)
    home = params.device
    outs = []
    for sh in shards:
        (e0, e1), (c0, c1) = sh.exps, sh.chains
        dev = sh.mcmc.device

        def mine(t, trailing):
            idx = (slice(None),) * (t.dim() - 2 - trailing) + (
                slice(e0, e1), slice(c0, c1))
            return t[idx].to(dev).contiguous()

        tail = 2 if full_cov else 1
        with mesh_lib.on(dev):
            outs.append(_segment(
                sh.mcmc, mine(params, 1), (mine(nll_pair[0], 0),
                                           mine(nll_pair[1], 0)),
                mine(width, tail), rb[e0:e1].to(dev).contiguous(),
                mine(noise, 1), mine(u, 0), debug_mode, m, full_cov,
                grouped))
    return _gather(outs, shards, home)


def _step_sums(x: torch.Tensor) -> torch.Tensor:
    """Each chain's float32 sum of an ``(nexp, nchains, n, ...)`` history
    over its n steps, on ``x``'s device.  Summed on the host, every
    chain's steps in one fixed pairwise order (numpy, the steps
    contiguous): a device reduction's order depends on how many chains it
    sums at once (a card splits few outputs over more blocks), and a
    chain's retunes must not depend on the chains beside it (a process's
    block, a mesh shard)."""
    a = np.ascontiguousarray(np.moveaxis(x.cpu().numpy(), 2, -1))
    return torch.as_tensor(a.sum(axis=-1), device=x.device)


def _step_cross(samples: torch.Tensor, cref: torch.Tensor) -> torch.Tensor:
    """Each chain's float32 sum over the steps of ``(x - c)(x - c)^T``,
    ``x`` the ``(nexp, nchains, n, npar)`` history and ``c`` the
    phase-start point ``(nexp, nchains, npar)``: on the host, in the one
    order of numpy's einsum loop (see :func:`_step_sums`)."""
    xc = samples.cpu().numpy() - cref.cpu().numpy()[:, :, None, :]
    return torch.as_tensor(np.einsum("ecsi,ecsj->ecij", xc, xc),
                           device=samples.device)


def _check_streams(noise, u, n, nexp, nchains, npar, m, phase, seg):
    lead = (n,) + ((m + 1,) if m else ()) + (nexp, nchains)
    if tuple(noise.shape) != lead + (npar,) or tuple(u.shape) != lead:
        raise ValueError(
            f"segment ({phase}, {seg}) streams are noise "
            f"{tuple(noise.shape)}, u {tuple(u.shape)}; the batch takes "
            f"{lead + (npar,)} and {lead}")


def _ckpt_file(path: str) -> str:
    return path + ".state.npz"


def _seg_file(path: str, phase: int, seg: int) -> str:
    return f"{path}.p{phase}s{seg}.npz"


def _save_state(path: str, **arrays) -> None:
    # np.savez appends ".npz" when missing, so the tmp name must end
    # with it for the atomic rename to find the file it wrote.
    tmp = _ckpt_file(path) + ".tmp.npz"
    np.savez(tmp, **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else v) for k, v in arrays.items()})
    os.replace(tmp, _ckpt_file(path))


def _run_segmented(fc: FitConfig, mcmc: MCMC, rb, nchains: int,
                   burnin_steps: int, nsteps: int, m: int, full_cov: bool,
                   grouped: bool, streams: StreamFn,
                   checkpoint_path: Optional[str], checkpoint_steps: int,
                   resume: bool, shards: Sequence[_Shard]):
    """The segmented batched walk (JAX ensemble.py:429-616): two burn-in
    phases, each followed by a retune of every chain from its running
    phase moments, then the sampling phase.  Without a checkpoint path
    each phase is one segment held in memory; with one, the state is
    written after every segment (see the module docstring).  Returns the
    sampling phase's ``samples (nexp, nchains, nkeep, npar)`` and NLL
    pairs ``(nexp, nchains, nkeep)`` as numpy."""
    if mcmc.stack._kde_exact:
        raise NotImplementedError(
            "segment checkpointing does not support kde_exact signals "
            "(per-experiment event-coordinate extras are not threaded "
            "through the segment steppers); run without "
            "checkpoint_steps, or use kde_exact=false (grid)")
    nexp = rb.shape[0]
    npar = mcmc.nparameters
    dev = mcmc.device
    remaining = max(nsteps - (2 * burnin_steps if burnin_steps > 0 else 0),
                    1)
    phases = [(burnin_steps, True)] * (2 if burnin_steps > 0 else 0)
    phases.append((remaining, False))

    state_file = _ckpt_file(checkpoint_path) if checkpoint_path else None
    if resume and state_file and os.path.exists(state_file):
        st = dict(np.load(state_file))
        params = as_f32(st["params"], dev)
        nll = (as_f32(st["nll_hi"], dev), as_f32(st["nll_lo"], dev))
        width = as_f32(st["width"], dev)
        phase0, done0 = int(st["phase"]), int(st["done"])
        count = as_f32(st["count"], dev)
        psum = as_f32(st["psum"], dev)
        psumsq = as_f32(st["psumsq"], dev) if "psumsq" in st else None
        pcross = as_f32(st["pcross"], dev) if "pcross" in st else None
        cref = as_f32(st["cref"], dev) if "cref" in st else None
    else:
        params, nll, width = _initial_batch(mcmc, rb, nchains, full_cov)
        phase0, done0 = 0, 0
        count = torch.zeros((), dtype=torch.float32, device=dev)
        psum = torch.zeros((nexp, nchains, npar), dtype=torch.float32,
                           device=dev)
        psumsq = None if full_cov else torch.zeros_like(psum)
        pcross = (torch.zeros((nexp, nchains, npar, npar),
                              dtype=torch.float32, device=dev)
                  if full_cov else None)
        cref = params if full_cov else None

    def moments():
        if full_cov:
            return dict(count=count, psum=psum, pcross=pcross, cref=cref)
        return dict(count=count, psum=psum, psumsq=psumsq)

    mem_segments = []
    for phase in range(phase0, len(phases)):
        phase_len, retune_after = phases[phase]
        ck = checkpoint_steps if checkpoint_steps > 0 else phase_len
        done = done0 if phase == phase0 else 0
        seg_idx = done // ck
        while done < phase_len:
            seg_len = min(ck, phase_len - done)
            noise, u = streams(phase, seg_idx, seg_len)
            _check_streams(noise, u, seg_len, nexp, nchains, npar, m, phase,
                           seg_idx)
            params, nll, samples, hist = _sharded_segment(
                shards, params, nll, width, rb, noise, u, fc.debug_mode, m,
                full_cov, grouped)
            if retune_after:
                count = count + float(seg_len)
                if full_cov:
                    psum = psum + _step_sums(samples - cref[:, :, None, :])
                    pcross = pcross + _step_cross(samples, cref)
                else:
                    psum = psum + _step_sums(samples)
                    psumsq = psumsq + _step_sums(samples * samples)
            elif checkpoint_path:
                np.savez(_seg_file(checkpoint_path, phase, seg_idx),
                         samples=samples.cpu().numpy(),
                         nll_hi=hist[0].cpu().numpy(),
                         nll_lo=hist[1].cpu().numpy())
            else:
                mem_segments.append((samples, hist[0], hist[1]))
            done += seg_len
            seg_idx += 1
            if checkpoint_path:
                _save_state(checkpoint_path, params=params, nll_hi=nll[0],
                            nll_lo=nll[1], width=width, phase=phase,
                            done=done, **moments())
        if retune_after:
            if full_cov:
                width = _sharded_retune_cov(mcmc, width, count, psum, pcross)
                pcross = torch.zeros_like(pcross)
                cref = params
            else:
                width = _sharded_retune(mcmc, width, count, psum, psumsq)
                psumsq = torch.zeros_like(psumsq)
            count = torch.zeros_like(count)
            psum = torch.zeros_like(psum)
            if checkpoint_path:
                _save_state(checkpoint_path, params=params, nll_hi=nll[0],
                            nll_lo=nll[1], width=width, phase=phase + 1,
                            done=0, **moments())
        done0 = 0

    # The sampling phase's history: persisted segments, or in memory.
    if checkpoint_path:
        parts, seg = [], 0
        sampling = len(phases) - 1
        while os.path.exists(_seg_file(checkpoint_path, sampling, seg)):
            d = np.load(_seg_file(checkpoint_path, sampling, seg))
            parts.append((d["samples"], d["nll_hi"], d["nll_lo"]))
            seg += 1
    else:
        parts = [tuple(t.cpu().numpy() for t in p) for p in mem_segments]
    samples = np.concatenate([p[0] for p in parts], axis=2)
    nlls = (np.concatenate([p[1] for p in parts], axis=2).astype(np.float64)
            + np.concatenate([p[2] for p in parts], axis=2))
    return samples, nlls


def _run_per_experiment(fc: FitConfig, mcmc: MCMC, rb, batch, nchains: int,
                        burnin_steps: int, nsteps: int, m: int,
                        streams: StreamFn, shards: Sequence[_Shard]):
    """Experiment by experiment through ``metropolis.run_chain`` (its
    lock-step chains, per-chain retunes from each burn-in phase's
    samples; the burn-in phases kept in debug mode), each phase's
    streams those of segment 0 of the grouped layout, each experiment on
    the device of the shard that holds it.  Returns ``samples (nexp,
    nchains, nkeep, npar)`` and NLLs ``(nexp, nchains, nkeep)``."""
    npar = mcmc.nparameters
    nexp = rb.shape[0]
    drawn = {}

    def phase_streams(k, n):
        if (k, n) not in drawn:
            noise, u = streams(k, 0, n)
            _check_streams(noise, u, n, nexp, nchains, npar, m, k, 0)
            drawn[(k, n)] = noise, u
        return drawn[(k, n)]

    samples, nlls = [], []
    for e in range(nexp):
        model = next(sh.mcmc for sh in shards
                     if sh.exps[0] <= e < sh.exps[1])
        dev = model.device

        def presampler(k, n, e=e, dev=dev):
            noise, u = phase_streams(k, n)
            noise, u = noise[..., e, :, :], u[..., e, :]
            if nchains == 1:  # run_chain's single chain has no chain axis
                noise, u = noise[..., 0, :], u[..., 0]
            return noise.to(dev).contiguous(), u.to(dev).contiguous()

        if model.stack._kde_exact:
            # This experiment's padded events for the kde_exact rows.
            model.stack.set_kde_points(batch[e])
        with mesh_lib.on(dev):
            s, (hi, lo), _ = metropolis.run_chain(
                model, rb[e].to(dev), nsteps, burnin_steps, fc.debug_mode,
                presampler, nchains, m, fc.proposal)
        samples.append(s.reshape(nchains, -1, npar).cpu().numpy())
        nlls.append(metropolis.nll_history_to_f64((hi, lo)).reshape(
            nchains, -1))
    return np.stack(samples), np.stack(nlls)


def _collect_results(fc: FitConfig, mcmc: MCMC, samples, nll_vals,
                     verbose: bool, experiments: Optional[Sequence[int]] = None):
    """(nexp, nchains, nkeep, ...) histories -> likelihood spaces and the
    upper limits on ``fc.signal_name`` (JAX ensemble.py:343-360), row k
    being global experiment ``experiments[k]`` (default k)."""
    lspaces, limits = [], []
    if experiments is None:
        experiments = range(samples.shape[0])
    for k, i in enumerate(experiments):
        ls = LikelihoodSpace.from_arrays(
            samples[k].reshape(-1, mcmc.nparameters),
            nll_vals[k].reshape(-1), mcmc.parameter_names,
            cl=fc.confidence, error_type=fc.error_type)
        lspaces.append(ls)
        if fc.signal_name and fc.signal_name in mcmc.parameter_names:
            bf = ls.get_best_fit()
            limits.append(bf[fc.signal_name].upper)
            if verbose:
                print(f"experiment {i}: {fc.signal_name}: "
                      f"{bf[fc.signal_name]}")
    return lspaces, limits


def fit_batch(fc: FitConfig, mcmc: MCMC, rb: torch.Tensor, batch,
              nsteps: int, streams: StreamFn,
              checkpoint_path: Optional[str] = None,
              checkpoint_steps: int = 0, resume: bool = False,
              mesh: Optional[Mesh] = None):
    """Fit the ``(nexp, nsignals, nevents)`` read bins ``rb`` (of the
    padded events ``batch``) as one batch of ``nexp x fc.nchains``
    chains from ``streams``: the grouped kernels where the stack takes
    them (segmented), else experiment by experiment; split over
    ``mesh``'s ``{exp, chain}`` blocks when given.  Returns ``(samples
    (nexp, nchains, nkeep, npar), NLLs (nexp, nchains, nkeep), route,
    M)``, the histories as numpy."""
    nchains = max(fc.nchains, 1)
    burnin_steps = int(nsteps * fc.burnin_fraction)
    full_cov = fc.proposal == "full_cov"
    m = (fc.rate_substeps
         if metropolis._blocked_enabled(mcmc, fc.rate_substeps) else 0)
    grouped = _fused_route_ok(mcmc, fc.rate_substeps)
    shards = _shards(fc, mcmc, mesh, rb.shape[0], nchains)
    # Debug (accept-all) fits keep the per-experiment runner, whose
    # history includes the burn-in phases; the segmented runner keeps
    # only the sampling phase.
    if checkpoint_steps > 0 or (grouped and not fc.debug_mode):
        route = "grouped" if grouped else "per experiment, segmented"
        samples, nlls = _run_segmented(
            fc, mcmc, rb, nchains, burnin_steps, nsteps, m, full_cov,
            grouped, streams, checkpoint_path, checkpoint_steps, resume,
            shards)
    else:
        route = "per experiment"
        samples, nlls = _run_per_experiment(fc, mcmc, rb, batch, nchains,
                                            burnin_steps, nsteps, m, streams,
                                            shards)
    if len(shards) > 1:
        route += f", {len(shards)} shards"
    return samples, nlls, route, m


def run_sharded_ensemble(
    fc: FitConfig,
    nsteps: Optional[int] = None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    checkpoint_steps: int = 0,
    resume: bool = False,
    device="cuda",
    stream_fn: Optional[StreamFn] = None,
    dataset_fn: Optional[Callable[[int], np.ndarray]] = None,
    metrics: Optional[MetricsLogger] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[List[LikelihoodSpace], List[float]]:
    """Generate and fit every experiment as one batch on ``device`` (the
    card unless the caller asks for the CPU), or over ``mesh``'s
    ``{exp, chain}`` blocks (then on its devices, the histories gathered
    on its first).

    ``checkpoint_steps > 0`` (with a ``checkpoint_path`` prefix) runs the
    walk in persisted segments; ``resume=True`` continues a killed run
    from its last completed segment.  ``stream_fn(phase, seg, n)`` and
    ``dataset_fn(i)``, when given, replace the segment streams and the
    fake datasets (how the tests feed both packages the same inputs).
    ``metrics`` gets the set-up time, the fit's wall and chain-steps/s
    (``nsteps * nexp * nchains / wall``, host clock around the fit, ending
    in a device synchronisation) and each experiment's limit.  Returns
    the likelihood spaces and the upper limits on ``fc.signal_name``.
    """
    nsteps = nsteps or fc.nsteps
    dev = resolve_device(mesh.flat()[0] if mesh is not None else device)
    if checkpoint_steps > 0 and not checkpoint_path:
        raise ValueError("checkpoint_steps > 0 requires checkpoint_path")
    metropolis.check_proposal(fc.proposal, fc.rate_substeps)
    devices = {dev} | set(mesh.flat() if mesh is not None else ())

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    sw = Stopwatch()
    mcmc, rb, batch, nchains, _ = _ensemble_setup(fc, nsteps, dev,
                                                  dataset_fn)
    sync()
    setup_s = sw.real_time()
    nexp = fc.nexperiments
    m = (fc.rate_substeps
         if metropolis._blocked_enabled(mcmc, fc.rate_substeps) else 0)
    streams = stream_fn or default_streams(fc.seed, nexp, nchains,
                                           mcmc.nparameters, m, dev)

    sw.start()
    samples, nlls, route, m = fit_batch(
        fc, mcmc, rb, batch, nsteps, streams, checkpoint_path,
        checkpoint_steps, resume, mesh)
    sync()
    wall = sw.real_time()
    if metrics is not None:
        metrics.log("sharded_setup", nexperiments=nexp,
                    nevents=int(rb.shape[-1]), seconds=setup_s)
        metrics.log("sharded_fit", route=route, nexperiments=nexp,
                    nchains=nchains, nsteps=nsteps, rate_substeps=m,
                    proposal=fc.proposal, wall_seconds=wall,
                    steps_per_sec=nsteps * nexp * nchains / max(wall, 1e-9),
                    device=str(dev))
    lspaces, limits = _collect_results(fc, mcmc, samples, nlls, verbose)
    if metrics is not None:
        for i, x in enumerate(limits):
            metrics.log("experiment_limit", experiment=i,
                        signal=fc.signal_name, upper=x)
    return lspaces, limits


def main_sharded(config_file: str, output_path: str, device="cuda",
                 data_root: Optional[str] = None,
                 binned: Optional[bool] = None,
                 rate_substeps: Optional[int] = None,
                 checkpoint_steps: int = 0,
                 resume: bool = False) -> List[float]:
    """``--sharded`` (JAX cli.py:145-162): fit every experiment as one
    batch, write ``<prefix>_<i>.<format>`` for each, print the best fits
    and the median upper limit; metrics go to
    ``<output_path>/<prefix>_metrics.jsonl``.  ``binned`` and
    ``rate_substeps``, when given, override the config.
    ``checkpoint_steps > 0`` checkpoints the batch every that many steps
    under ``<output_path>/<prefix>_sharded`` (resumed with ``resume``;
    the files are removed once the fit completes)."""
    fc = FitConfig.from_json_file(config_file, data_root=data_root)
    if binned is not None:
        fc.binned = binned
    if rate_substeps is not None:
        fc.rate_substeps = rate_substeps
    print(fc.print())
    os.makedirs(output_path, exist_ok=True)
    metrics = MetricsLogger(os.path.join(
        output_path, f"{fc.output_prefix}_metrics.jsonl"))
    print(f"sxmc_tpu_torch: Running the sharded ensemble on {device}...")
    ckpt = (os.path.join(output_path, f"{fc.output_prefix}_sharded")
            if checkpoint_steps > 0 else None)
    lspaces, limits = run_sharded_ensemble(
        fc, device=device, metrics=metrics, checkpoint_path=ckpt,
        checkpoint_steps=checkpoint_steps, resume=resume)
    if ckpt:
        prefix = os.path.basename(ckpt) + "."
        for name in os.listdir(output_path):
            if name.startswith(prefix) and name.endswith(".npz"):
                os.remove(os.path.join(output_path, name))
    for i, ls in enumerate(lspaces):
        ls.save(os.path.join(output_path,
                             f"{fc.output_prefix}_{i}.{fc.output_format}"))
        print(ls.print_best_fit())
    if limits:
        print(f"sxmc_tpu_torch: Median upper limit: {median(limits)}")
    return limits
