"""The hand-written Hopper kernels: build, bind, wrap, count.

Five kernels carry the Metropolis fits (sources and notes in
``sxmc_tpu_torch/csrc/``):

  B1 :func:`segmented_histogram`  <- sxmc_tpu/ops/pallas_hist.py::
     pallas_histogram_segmented (fake-data generation, EvalHist, the
     split path's one build, the binned likelihood);
     :func:`segmented_histogram_batched` is its ``(nchains, npar)``
     theta form (the binned likelihood with lock-step chains)
  B2 :func:`lut_eval`             <- sxmc_tpu/ops/pallas_hist.py::
     pallas_eval_lut (PdfStack.evaluate / evaluate_batch, EvalHist.eval);
     :class:`LutPlan` is its plan for one read-bins tensor, made once
     where the read bins are fixed, so that a call only checks the table
     and launches
  B3 :func:`fused_nll`            <- sxmc_tpu/ops/pallas_step.py::
     pallas_fused_step (a chain's initial NLL); :func:`fused_nll_batched`
     for ``(nchains, npar)`` params
  B4 :func:`fused_segment`        <- sxmc_tpu/ops/pallas_step.py::
     pallas_fused_segment (one whole fixed-width Metropolis phase);
     :func:`fused_segment_batched` for lock-step chains;
     :func:`fused_segment_tril` and :func:`fused_segment_tril_batched`
     for full-covariance proposals ``cur + L @ z``;
     :func:`fused_segment_tempered` for a parallel-tempering ladder (a
     per-chain inverse temperature in the accept)
  B5 :func:`blocked_segment`      <- sxmc_tpu/ops/pallas_step.py::
     pallas_fused_segment_blocked (one whole blocked Metropolis-within-
     Gibbs phase); :func:`blocked_segment_batched` for lock-step chains

The experiment-grouped forms of B4 and B5 (:func:`fused_segment_grouped`,
:func:`fused_segment_tril_grouped`, :func:`blocked_segment_grouped`)
carry the sharded ensemble: the chains of every experiment in one
batch, chain c reading the read bins of experiment c // chains-per-
experiment, every chain sharing each read of the MC samples.  A batch
larger than one launch's chain caps goes out in launches of whole
experiments.

Weighted MC samples (``HistSpec.weighted``: the samples carry a weight
row after their fields) run through B1, B3 and B4 in their weighted
forms: bins and norms are float64 weight sums, rounded once to float32
(the TPU kernels' ``has_weights`` / ``has_wrow``).  B5 takes unweighted
samples only, as in the JAX package.

Each form takes one shape and counts its launches under its own name
(the wrapper's name, with ``_weighted`` appended for weighted samples),
so that a run shows which form ran (:func:`launch_counts`).  Each
wrapper checks its inputs, and then takes one of two routes decided
only by where the tensors lie: on the CPU it runs the plain PyTorch
version beside it (``*_plain``), on a CUDA device it launches the
kernel or raises.  There is no fallback from the card to the plain
version.  Every launch, and nothing else, adds one to its form's
count.

The library is compiled at first use, one nvcc per source, all started
together, into ``build/sxmc_kernels/<hash of the sources>/`` beside the
package, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.ops import histogram as hist_ops
from sxmc_tpu_torch.ops import transforms
from sxmc_tpu_torch.ops.nll import NLLConsts, NLLStatic, df_diff, nll_pair

# Limits of the C struct SxSpec (csrc/sxmc_phases.cuh).
MAXOBS, MAXFIELDS, MAXSEG, MAXSIG = 4, 8, 32, 32
MAXSYST, MAXPOW, MAXPAR = 8, 4, 64
MAXCHAINS, MAXCP, MAXCS = 32, 512, 256  # chains; x params; x signals

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")


# ---------------------------------------------------------------- specs


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """Sample layout, binning and masked systematics of a histogram.

    ``samples`` tensors are field-major ``(nfields, n)`` float32, the
    dynamic segments back to back: segment d is columns
    ``seg_off[d]:seg_off[d + 1]``; ``weighted`` samples carry one more
    row, each sample's weight (``(nfields + 1, n)``).  ``systematics``
    holds ``(desc, mask)`` pairs, ``mask[d]`` true where the systematic
    acts on segment d; ``desc.par_indices`` index the systematic-
    parameter vector theta.
    """

    nfields: int
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    nbins: Tuple[int, ...]
    systematics: Tuple[Tuple[transforms.SystematicDesc, Tuple[bool, ...]],
                       ...]
    seg_off: Tuple[int, ...]
    weighted: bool = False
    # B1's per-layout state, made at its first launch: its C spec and
    # each (chains, device)'s grid and slots (b1_grid: the autotuner's
    # verdict for the shape, else sx_hist_grid's rule).
    _b1: dict = dataclasses.field(default_factory=dict, init=False,
                                  repr=False, compare=False, hash=False)

    @classmethod
    def build(cls, nfields, lower, upper, nbins, systematics, seg_off,
              weighted: bool = False):
        spec = cls(int(nfields), tuple(float(x) for x in lower),
                   tuple(float(x) for x in upper),
                   tuple(int(b) for b in nbins),
                   tuple((d, tuple(bool(b) for b in m))
                         for d, m in systematics),
                   tuple(int(x) for x in seg_off), bool(weighted))
        spec.validate()
        return spec

    @functools.cached_property
    def nrows(self) -> int:
        """Rows of the samples tensor: the fields, and the weights."""
        return self.nfields + int(self.weighted)

    @functools.cached_property
    def nobs(self) -> int:
        return len(self.nbins)

    @property
    def nload(self) -> int:
        """Fields the kernels hold in registers: the observables, then
        every field after them that a systematic transforms (a truth
        field that a later resolution systematic reads)."""
        return max([self.nobs] + [d.obs + 1 for d, _ in self.systematics])

    @functools.cached_property
    def npar(self) -> int:
        """Entries of theta the systematics read."""
        return max((max(d.par_indices) + 1 for d, _ in self.systematics),
                   default=0)

    @functools.cached_property
    def ndyn(self) -> int:
        return len(self.seg_off) - 1

    @functools.cached_property
    def total(self) -> int:
        return hist_ops.total_bins(self.nbins)

    @functools.cached_property
    def n(self) -> int:
        return self.seg_off[-1]

    def validate(self) -> None:
        if not 1 <= self.nobs <= MAXOBS:
            raise ValueError(f"{self.nobs} observables (kernels take "
                             f"1..{MAXOBS})")
        if not self.nobs <= self.nfields <= MAXFIELDS:
            raise ValueError(f"{self.nfields} sample fields (kernels take "
                             f"up to {MAXFIELDS})")
        if not 1 <= self.ndyn <= MAXSEG:
            raise ValueError(f"{self.ndyn} dynamic segments (kernels take "
                             f"1..{MAXSEG})")
        if len(self.systematics) > MAXSYST:
            raise ValueError(f"{len(self.systematics)} systematics "
                             f"(kernels take up to {MAXSYST})")
        for desc, mask in self.systematics:
            if not 1 <= desc.npars <= MAXPOW or len(mask) != self.ndyn \
                    or not 0 <= desc.obs < self.nfields \
                    or not 0 <= desc.extra_field < self.nfields:
                raise ValueError(f"bad systematic {desc} / mask {mask}")
        if list(self.seg_off) != sorted(self.seg_off) or \
                self.seg_off[0] != 0 or self.n >= 2 ** 31:
            raise ValueError(f"bad segment offsets {self.seg_off}")


@dataclasses.dataclass(frozen=True)
class NLLSpec:
    """What the fused kernels need beyond the histogram: the NLL
    constants (on the host for the kernels' C spec, on the device for
    the plain versions), which dynamic segment (or -1: static row) each
    signal is, the static signals' in-domain counts and the bin
    volume."""

    st: NLLStatic
    consts: NLLConsts
    sig_slot: Tuple[int, ...]
    norm_init: Tuple[float, ...]
    bin_volume: float

    @property
    def nsig(self) -> int:
        return len(self.sig_slot)

    @property
    def npar(self) -> int:
        return len(self.st.means)

    def validate(self) -> None:
        if not 1 <= self.nsig <= MAXSIG or not 1 <= self.npar <= MAXPAR:
            raise ValueError(f"{self.nsig} signals / {self.npar} parameters "
                             f"(kernels take up to {MAXSIG} / {MAXPAR})")


class _CSpec(ctypes.Structure):
    """Field-by-field mirror of ``SxSpec`` (csrc/sxmc_phases.cuh)."""

    _fields_ = [
        ("nfields", ctypes.c_int), ("nobs", ctypes.c_int),
        ("nload", ctypes.c_int), ("total", ctypes.c_int),
        ("ndyn", ctypes.c_int),
        ("nsyst", ctypes.c_int),
        ("nbins", ctypes.c_int * MAXOBS), ("strides", ctypes.c_int * MAXOBS),
        ("seg_off", ctypes.c_int * (MAXSEG + 1)),
        ("syst_type", ctypes.c_int * MAXSYST),
        ("syst_obs", ctypes.c_int * MAXSYST),
        ("syst_extra", ctypes.c_int * MAXSYST),
        ("syst_npow", ctypes.c_int * MAXSYST),
        ("syst_par", ctypes.c_int * (MAXSYST * MAXPOW)),
        ("syst_mask", ctypes.c_uint * MAXSYST),
        ("lower", ctypes.c_float * MAXOBS), ("upper", ctypes.c_float * MAXOBS),
        ("scale", ctypes.c_float * MAXOBS),
        ("nsig", ctypes.c_int), ("npar", ctypes.c_int),
        ("nsources", ctypes.c_int),
        ("sig_slot", ctypes.c_int * MAXSIG),
        ("source_id", ctypes.c_int * MAXSIG),
        ("bin_volume", ctypes.c_float),
        ("nexpected", ctypes.c_float * MAXSIG),
        ("n_mc", ctypes.c_float * MAXSIG),
        ("norm_init", ctypes.c_float * MAXSIG),
        ("means", ctypes.c_float * MAXPAR),
        ("sigmas", ctypes.c_float * MAXPAR),
    ]


def _c_spec(hs: HistSpec, ns: Optional[NLLSpec], par_off: int) -> _CSpec:
    c = _CSpec()
    c.nfields, c.nobs, c.nload = hs.nfields, hs.nobs, hs.nload
    c.total = hs.total
    c.ndyn, c.nsyst = hs.ndyn, len(hs.systematics)
    scales = hist_ops.bin_scales(hs.lower, hs.upper, hs.nbins)
    for a, (nb, st) in enumerate(zip(hs.nbins,
                                     hist_ops.bin_strides(hs.nbins))):
        c.nbins[a], c.strides[a] = nb, st
        c.lower[a] = np.float32(hs.lower[a])
        c.upper[a] = np.float32(hs.upper[a])
        c.scale[a] = scales[a]
    for d, off in enumerate(hs.seg_off):
        c.seg_off[d] = off
    for k, (desc, mask) in enumerate(hs.systematics):
        c.syst_type[k], c.syst_obs[k] = desc.type, desc.obs
        c.syst_extra[k], c.syst_npow[k] = desc.extra_field, desc.npars
        for q, pidx in enumerate(desc.par_indices):
            c.syst_par[k * MAXPOW + q] = par_off + pidx
        c.syst_mask[k] = sum(1 << d for d, on in enumerate(mask) if on)
    if ns is not None:
        st = ns.st
        c.nsig, c.npar, c.nsources = ns.nsig, ns.npar, int(st.nsources)
        c.bin_volume = np.float32(ns.bin_volume)
        for j in range(ns.nsig):
            c.sig_slot[j] = ns.sig_slot[j]
            c.source_id[j] = int(st.source_id[j])
            c.nexpected[j] = np.float32(st.nexpected[j])
            c.n_mc[j] = np.float32(st.n_mc[j])
            c.norm_init[j] = np.float32(ns.norm_init[j])
        for k in range(ns.npar):
            c.means[k] = np.float32(st.means[k])
            c.sigmas[k] = np.float32(st.sigmas[k])
    return c


# ---------------------------------------------------------------- build


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's default prefix
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _build_dir() -> Path:
    return _CSRC.parent.parent / "build" / "sxmc_kernels"


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernel library if needed; returns where it is, how
    long the build took (0 when it was already built) and nvcc's log.
    One nvcc per source, all started together, then one link."""
    out_dir = _build_dir() / _sources_hash()
    lib = out_dir / "libsxmc_kernels.so"
    log = out_dir / "build.log"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""}
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    srcs = sorted(_CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out_dir / f"libsxmc_kernels.{tag}.tmp.so"
    t0 = time.perf_counter()
    cmds = [[nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    text = ""
    for cmd, proc in zip(cmds, procs):
        text += " ".join(cmd) + "\n" + proc.communicate()[0]
    ok = all(proc.returncode == 0 for proc in procs)
    if ok:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        text += " ".join(cmd) + "\n" + link.stdout + link.stderr
        ok = link.returncode == 0
    seconds = time.perf_counter() - t0
    log.write_text(text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if not ok:
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "log": text}


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    if torch.cuda.get_device_capability() != (9, 0):
        raise RuntimeError(
            "the sxmc_tpu_torch kernels are built for sm_90a (Hopper); "
            f"this card is {torch.cuda.get_device_name()} "
            f"(sm_{''.join(map(str, torch.cuda.get_device_capability()))})")
    lib = ctypes.CDLL(build()["path"])
    lib.sx_spec_size.argtypes, lib.sx_spec_size.restype = [], _I
    lib.sx_error_string.argtypes = [_I]
    lib.sx_error_string.restype = ctypes.c_char_p
    lib.sx_hist_grid.argtypes = [_P, _I, _I, _P, _P]
    lib.sx_hist_grid.restype = _I
    # sx_hist_limits: spec, nchains, weighted, nslot -> occupancy, the
    # most slots, chunks, SMs (the autotuner's sweep).
    lib.sx_hist_limits.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P]
    lib.sx_hist_limits.restype = _I
    # sx_histogram: spec, nchains, weighted, samples, par, pstride,
    # nblocks, nslot, acc, ticket, out, stream.
    lib.sx_histogram.argtypes = [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                                 _P]
    lib.sx_histogram.restype = _I
    lib.sx_lut_plan_size.argtypes, lib.sx_lut_plan_size.restype = [], _I
    lib.sx_lut_limits.argtypes, lib.sx_lut_limits.restype = [_I, _P, _P], _I
    lib.sx_lut_occupancy.argtypes = [_I, _I, _I, _P]
    lib.sx_lut_occupancy.restype = _I
    # sx_eval_lut: plan, counts, norms, out, stream.
    lib.sx_eval_lut.argtypes = [_P, _P, _P, _P, _P]
    lib.sx_eval_lut.restype = _I
    lib.sx_fused_grid.argtypes = [_P, _I, _I, _P]
    lib.sx_fused_grid.restype = _I
    # sx_fused: spec, nchains, cpe, form, samples, hist_init, rb, nev,
    # params0, nll0, width, beta, noise, log_u, nsteps, debug, scratch,
    # partials, nblocks, samples_out, nlls_out, acc_out, stream.
    lib.sx_fused.argtypes = [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                             _P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P]
    lib.sx_fused.restype = _I
    lib.sx_blocked_grid.argtypes = [_P, _I, _P]
    lib.sx_blocked_grid.restype = _I
    # sx_blocked: spec, nchains, cpe, samples, hist_init, rb, nev,
    # params0, nll0, width, noise, log_u, ncycles, nsub, debug, scratch,
    # partials, nblocks, samples_out, nlls_out, acc_out, stream.
    lib.sx_blocked.argtypes = [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                               _P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P]
    lib.sx_blocked.restype = _I
    for c_name, size, py in (("SxSpec", lib.sx_spec_size(), _CSpec),
                             ("SxLutPlan", lib.sx_lut_plan_size(),
                              _CLutPlan)):
        if size != ctypes.sizeof(py):
            raise RuntimeError(f"{c_name} is {size} bytes in C but "
                               f"{ctypes.sizeof(py)} in ops/kernels.py")
    return lib


def _check_cuda(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.sx_error_string(err).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raw_stream(index: int) -> int:
    """The raw handle of the current stream on CUDA device ``index``
    (the one a caller made current, as ``torch.cuda.stream`` or
    ``parallel.mesh.on`` do), without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


# ------------------------------------------------------------- checks


def _expect(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_samples(hs: HistSpec, samples: torch.Tensor) -> None:
    _expect(samples, "samples", (hs.nrows, hs.n), torch.float32,
            samples.device)


# ------------------------------------------------------ plain versions


def _dyn_counts_plain(hs: HistSpec, samples: torch.Tensor,
                      par: torch.Tensor, par_off: int) -> torch.Tensor:
    """``(ndyn, total)`` int64 counts (float64 weight sums for weighted
    samples), or ``(nchains, ndyn, total)`` for ``(nchains, npar)``
    parameters: the plain version of the rebuild every kernel here
    does."""
    dev = samples.device
    cols = [samples[f] for f in range(hs.nfields)]
    batched = par.dim() == 2
    theta = par[..., par_off:]
    if batched:
        # theta[pidx] becomes a (nchains, 1) column: every transformed
        # field broadcasts to (nchains, n), one row per chain.
        theta = theta.T.unsqueeze(-1)
    for desc, mask in hs.systematics:
        if not any(mask):
            continue
        new = transforms.transform_field(desc, cols, theta)
        if all(mask):
            cols[desc.obs] = new
        else:
            sizes = torch.as_tensor(np.diff(hs.seg_off), device=dev)
            on = torch.repeat_interleave(torch.as_tensor(mask, device=dev),
                                         sizes)
            cols[desc.obs] = torch.where(on, new, cols[desc.obs])
    nch = par.shape[0] if batched else 1
    # int32 ids: the same integers, converted and counted faster.
    ids, valid = hist_ops.bin_ids_of_columns(cols[:hs.nobs], hs.lower,
                                             hs.upper, hs.nbins,
                                             dtype=torch.int32)
    # Out-of-domain samples go to a spare bin (index total) of every
    # (chain, segment) row, cut off below; one count over every row.
    width = hs.total + 1
    flat = torch.where(valid, ids, hs.total) + _row_base(hs.seg_off, width,
                                                         dev)
    if batched:
        flat = flat + torch.arange(nch, device=dev,
                                   dtype=torch.int32)[:, None] * (
            hs.ndyn * width)
    flat = flat.expand(nch, hs.n).reshape(-1)
    if hs.weighted:
        w = samples[hs.nfields].to(torch.float64)
        counts = torch.zeros(nch * hs.ndyn * width, dtype=torch.float64,
                             device=dev)
        counts.index_add_(0, flat, w.expand(nch, hs.n).reshape(-1))
    else:
        counts = torch.bincount(flat, minlength=nch * hs.ndyn * width)
    counts = counts.reshape(nch, hs.ndyn, width)[..., :hs.total]
    return counts if batched else counts[0]


@functools.lru_cache(maxsize=16)
def _row_base(seg_off: Tuple[int, ...], width: int,
              device: torch.device) -> torch.Tensor:
    """``(n,)`` int32: each sample's segment times ``width``."""
    sizes = torch.as_tensor(np.diff(seg_off), device=device)
    return torch.repeat_interleave(
        torch.arange(len(seg_off) - 1, device=device,
                     dtype=torch.int32) * width, sizes)


def segmented_histogram_plain(hs: HistSpec, samples: torch.Tensor,
                              theta: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1 (single and batched): ``([nchains,] ndyn,
    total)`` float32 counts and the ``([nchains,] ndyn)`` float32
    in-domain counts (integer sums, then cast; weighted: float64 sums,
    rounded once)."""
    counts = _dyn_counts_plain(hs, samples, theta, 0)
    return counts.to(torch.float32), counts.sum(dim=-1).to(torch.float32)


def lut_eval_plain(counts: torch.Tensor, norms: torch.Tensor,
                   read_bins: torch.Tensor, bin_volume: float
                   ) -> torch.Tensor:
    """Plain version of B2: ``counts[s, rb] / (norms[s] * bin_volume)``
    with the -1 -> NaN and -2 -> 0 sentinels; row s reads read-bin row
    ``s % len(read_bins)``."""
    from sxmc_tpu_torch.pdf.evalhist import eval_from_bins

    reps = counts.shape[0] // read_bins.shape[0]
    rb = read_bins.repeat(reps, 1) if reps > 1 else read_bins
    return eval_from_bins(counts, norms, bin_volume, rb)


def assemble(ns: NLLSpec, hist_init: torch.Tensor,
             counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full ``([nchains,] nsig, total)`` float32 table + ``([nchains,]
    nsig)`` norms from the static rows and the dynamic segments'
    counts ``([nchains,] ndyn, total)`` (integers, or float64 weight
    sums: each rounded once to float32)."""
    dev = hist_init.device
    lead = tuple(counts.shape[:-2])
    dyn = [j for j, s in enumerate(ns.sig_slot) if s >= 0]
    slots = torch.as_tensor([ns.sig_slot[j] for j in dyn], device=dev)
    idx = torch.as_tensor(dyn, device=dev)
    hists = hist_init.expand(*lead, *hist_init.shape).clone()
    hists[..., idx, :] = counts[..., slots, :].to(torch.float32)
    norms = torch.as_tensor(np.asarray(ns.norm_init, np.float32),
                            device=dev).expand(*lead, ns.nsig).clone()
    norms[..., idx] = counts[..., slots, :].sum(dim=-1).to(torch.float32)
    return hists, norms


def _state_plain(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                 hist_init: torch.Tensor, params: torch.Tensor):
    """The full histograms and norms at ``params`` (``(npar,)`` or
    ``(nchains, npar)``): the rebuild of the fused kernels."""
    counts = _dyn_counts_plain(hs, samples, params, int(ns.st.nsources))
    return assemble(ns, hist_init, counts)


def _nll_from_state_plain(hs: HistSpec, ns: NLLSpec, rb: torch.Tensor,
                          params: torch.Tensor, hists: torch.Tensor,
                          norms: torch.Tensor):
    """LUT from the histograms, then ``nll_pair``; ``rb`` is one
    dataset's ``(nsig, nev)`` or each chain's ``(nchains, nsig, nev)``
    (:func:`chain_read_bins`)."""
    nev = rb.shape[-1]
    lut = lut_eval_plain(hists.reshape(-1, hs.total), norms.reshape(-1),
                         rb.reshape(-1, nev), ns.bin_volume)
    lut = lut.reshape(*hists.shape[:-1], nev)
    return nll_pair(params, lut, norms, ns.consts)


def chain_read_bins(rb: torch.Tensor, nch: int) -> torch.Tensor:
    """Each chain's read bins ``(nch, nsig, nev)`` from the experiment-
    grouped ``(nexp, nsig, nev)``: chain c reads experiment c // (nch //
    nexp).  The plain versions of the grouped forms are the batched
    ones on these rows."""
    return rb.repeat_interleave(nch // rb.shape[0], dim=0)


def fused_nll_plain(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                    hist_init: torch.Tensor, rb: torch.Tensor,
                    params: torch.Tensor):
    """Plain version of B3 (single and batched): rebuild, LUT,
    ``nll_pair``."""
    hists, norms = _state_plain(hs, ns, samples, hist_init, params)
    return _nll_from_state_plain(hs, ns, rb, params, hists, norms)


def tril_propose_plain(cur: torch.Tensor, tril: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """``cur + L @ z`` in the kernels' order: row k sums ``L[k, j] *
    z[j]`` for j = 0..k from 0.0 in ascending j, one rounded add per
    term (a matmul would reorder the sum).  ``cur`` and ``z`` ``(...,
    npar)``, ``tril`` ``(..., npar, npar)``."""
    npar = cur.shape[-1]
    k = torch.arange(npar, device=cur.device)
    acc = torch.zeros_like(cur)
    for j in range(npar):
        acc = torch.where(k >= j, acc + tril[..., j] * z[..., j:j + 1], acc)
    return cur + acc


def _accept_plain(cur_hi, cur_lo, hi, lo, log_u, debug_mode: bool,
                  beta=None):
    """df_diff's op order, then the kernels' log-space accept ``delta > 0
    or log(u) <= delta``, delta annealed by ``beta`` ``(nchains,)`` when
    given (the tempered form)."""
    delta = df_diff(cur_hi, cur_lo, hi, lo)
    if beta is not None:
        delta = beta * delta
    acc = (delta > 0) | (log_u <= delta)
    return torch.ones_like(acc) if debug_mode else acc


def fused_segment_plain(hs, ns, samples, hist_init, rb, params0, nll0,
                        width, noise, log_u, debug_mode: bool = False,
                        beta=None):
    """Plain version of B4 (single and batched, diagonal or tril,
    tempered with ``beta``): the step loop, one :func:`fused_nll_plain`
    per proposal, the log-space accept.  ``width`` one dimension longer
    than ``params0`` is the tril (:func:`tril_propose_plain`).  Stays on
    the device (no host synchronisation per step)."""
    cur = params0.clone()
    cur_hi, cur_lo = nll0[..., 0].clone(), nll0[..., 1].clone()
    tril = width.dim() == params0.dim() + 1
    wpos = torch.clamp_min(width, 0.0)
    out_s, out_n, out_a = [], [], []
    for s in range(noise.shape[0]):
        if tril:
            prop = tril_propose_plain(cur, width, noise[s])
        else:
            prop = torch.where(width > 0, cur + noise[s] * wpos, cur)
        hi, lo = fused_nll_plain(hs, ns, samples, hist_init, rb, prop)
        acc = _accept_plain(cur_hi, cur_lo, hi, lo, log_u[s], debug_mode,
                            beta)
        cur = torch.where(acc[..., None], prop, cur)
        cur_hi = torch.where(acc, hi, cur_hi)
        cur_lo = torch.where(acc, lo, cur_lo)
        out_s.append(cur)
        out_n.append(torch.stack([cur_hi, cur_lo], dim=-1))
        out_a.append(acc.to(torch.float32))
    return torch.stack(out_s), torch.stack(out_n), torch.stack(out_a)


def fused_segment_grouped_plain(hs, ns, samples, hist_init, rb, params0,
                                nll0, width, noise, log_u,
                                debug_mode: bool = False):
    """Plain version of B4's experiment-grouped forms (diagonal, or tril
    for ``width`` ``(nch, npar, npar)``): :func:`fused_segment_plain`
    with chain c scoring experiment c // cpe's read bins ``rb`` ``(nexp,
    nsig, nev)``."""
    return fused_segment_plain(hs, ns, samples, hist_init,
                               chain_read_bins(rb, params0.shape[0]),
                               params0, nll0, width, noise, log_u,
                               debug_mode)


def blocked_segment_grouped_plain(hs, ns, samples, hist_init, rb, params0,
                                  nll0, width, noise, log_u,
                                  debug_mode: bool = False):
    """Plain version of B5's experiment-grouped form: as
    :func:`fused_segment_grouped_plain`, for blocked cycles."""
    return blocked_segment_plain(hs, ns, samples, hist_init,
                                 chain_read_bins(rb, params0.shape[0]),
                                 params0, nll0, width, noise, log_u,
                                 debug_mode)


def blocked_segment_plain(hs, ns, samples, hist_init, rb, params0, nll0,
                          width, noise, log_u, debug_mode: bool = False):
    """Plain version of B5 (single and batched): per cycle one
    systematic-block move (every parameter but the rates, rebuilt and
    scored as :func:`fused_nll_plain` does) and ``M = noise.shape[1] -
    1`` rate-block moves scored against the carried current histograms
    and norms (``lut_eval_plain`` + ``nll_pair``), each decided with the
    log-space accept.  ``noise`` ``(n, M + 1[, nchains], npar)``,
    ``log_u`` ``(n, M + 1[, nchains])``; returns the per-cycle histories
    and accepted fractions."""
    nsub = noise.shape[1]
    cur = params0.clone()
    cur_hi, cur_lo = nll0[..., 0].clone(), nll0[..., 1].clone()
    rate = torch.arange(params0.shape[-1],
                        device=params0.device) < int(ns.st.nsources)
    wpos = torch.clamp_min(width, 0.0)
    hist_cur, norms_cur = _state_plain(hs, ns, samples, hist_init, cur)
    out_s, out_n, out_a = [], [], []
    for s in range(noise.shape[0]):
        accn = torch.zeros_like(cur_hi)
        for sub in range(nsub):
            move = (width > 0) & (rate if sub else ~rate)
            prop = torch.where(move, cur + noise[s, sub] * wpos, cur)
            if sub == 0:
                hists, norms = _state_plain(hs, ns, samples, hist_init, prop)
            else:
                hists, norms = hist_cur, norms_cur
            hi, lo = _nll_from_state_plain(hs, ns, rb, prop, hists, norms)
            acc = _accept_plain(cur_hi, cur_lo, hi, lo, log_u[s, sub],
                                debug_mode)
            cur = torch.where(acc[..., None], prop, cur)
            cur_hi = torch.where(acc, hi, cur_hi)
            cur_lo = torch.where(acc, lo, cur_lo)
            if sub == 0:
                hist_cur = torch.where(acc[..., None, None], hists, hist_cur)
                norms_cur = torch.where(acc[..., None], norms, norms_cur)
            accn = accn + acc.to(torch.float32)
        out_s.append(cur)
        out_n.append(torch.stack([cur_hi, cur_lo], dim=-1))
        out_a.append(accn / nsub)
    return torch.stack(out_s), torch.stack(out_n), torch.stack(out_a)


# ------------------------------------------------------------ wrappers


def _check_theta(hs: HistSpec, theta: torch.Tensor, ndim: int,
                 device) -> None:
    if theta.dim() != ndim or theta.shape[-1] < hs.npar:
        want = "(npar,)" if ndim == 1 else "(nchains, npar)"
        raise ValueError(f"theta has shape {tuple(theta.shape)}, needs "
                         f"{want} with npar >= {hs.npar}")
    _expect(theta, "theta", theta.shape, torch.float32, device)


def _acc_dtype(hs: HistSpec) -> torch.dtype:
    """The kernels' accumulator: unsigned counts (int32 storage) or
    float64 weight sums."""
    return torch.float64 if hs.weighted else torch.int32


# B1's persistent accumulators, one per (device, stream): (int64 words,
# their address, cells), the counts (unsigned or float64) from the first
# word, the last word the blocks' ticket.  Zeroed when made; every launch
# leaves them zeroed.  One per stream, because launches on two streams of
# a device may run at once; each lives as long as the process, so B1 is
# meant to be called from long-lived streams (the current stream, as the
# port does), not from a new stream for every call.
_B1_ACC: dict = {}


def _b1_accumulator(dev: torch.device, stream: int, cells: int):
    """(cells address, ticket address) of ``stream``'s accumulator, made
    (or remade larger) for at least ``cells`` cells."""
    key = (dev.index, stream)
    got = _B1_ACC.get(key)
    if got is None or got[2] < cells:
        buf = torch.zeros(max(cells, 1024) + 1, dtype=torch.int64,
                          device=dev)
        got = _B1_ACC[key] = (buf, buf.data_ptr(), buf.shape[0] - 1)
    return got[1], got[1] + 8 * got[2]


def _b1_spec(hs: HistSpec) -> _CSpec:
    cs = hs._b1.get("spec")
    if cs is None:
        cs = hs._b1["spec"] = _c_spec(hs, None, 0)
    return cs


def b1_grid(hs: HistSpec, nch: int, dev: torch.device,
            tuned: bool = True) -> Tuple[int, int]:
    """B1's ``(blocks, slots)`` for this layout and chain count on
    ``dev``: sx_hist_grid's rule, or with ``tuned`` the autotuner's
    verdict for the shape where one is recorded."""
    lib = _library()
    nb, ns = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        _check_cuda(lib, lib.sx_hist_grid(ctypes.byref(_b1_spec(hs)), nch,
                                          int(hs.weighted), ctypes.byref(nb),
                                          ctypes.byref(ns)), "sx_hist_grid")
    rule = (nb.value, ns.value)
    if not tuned:
        return rule
    from sxmc_tpu_torch.ops import autotune

    return autotune.tuned_grid(autotune.kind_of(hs), hs.total, hs.ndyn,
                               hs.n, nch, hs.weighted, rule)


def b1_limits(hs: HistSpec, nch: int, dev: torch.device, nslot: int):
    """``(blocks per SM, most slots, chunks, SMs)`` of B1 at ``nslot``
    slots for this layout and chain count on ``dev`` (sx_hist_limits):
    the autotuner's sweep stays within them."""
    lib = _library()
    occ, most, nsm = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    chunks = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        _check_cuda(lib, lib.sx_hist_limits(
            ctypes.byref(_b1_spec(hs)), nch, int(hs.weighted), nslot,
            ctypes.byref(occ), ctypes.byref(most), ctypes.byref(chunks),
            ctypes.byref(nsm)), "sx_hist_limits")
    return occ.value, most.value, chunks.value, nsm.value


def launch_histogram_at(hs: HistSpec, samples: torch.Tensor,
                        theta: torch.Tensor, nch: int,
                        grid: Tuple[int, int]):
    """One B1 launch on ``grid`` = ``(blocks, slots)`` instead of the
    plan's (the autotuner's sweep and B1's probe; not counted as a
    launch): ``(counts (nch, ndyn, total), norms (nch, ndyn))``."""
    _check_samples(hs, samples)
    _check_theta(hs, theta, 2 if nch > 1 else 1, samples.device)
    return _launch_histogram(hs, samples, theta, nch, "B1 at a grid",
                             grid=grid)


def _launch_histogram(hs: HistSpec, samples: torch.Tensor,
                      theta: torch.Tensor, nch: int, what: str,
                      one: bool = False, grid=None):
    """One B1 launch: ``(counts (nch, ndyn, total), norms (nch, ndyn))``
    float32, without the chain axis when ``one``, on ``grid`` or the
    plan's.  The plan is made at the first launch for a layout, chain
    count and device (the host cost of a call is what it must check and
    launch): the grid and slots of the autotuner's verdict for the
    shape, where one is recorded (``ops.autotune.tuned_grid``), else of
    sx_hist_grid's rule."""
    dev = samples.device
    lib = _library()
    nh = nch * hs.ndyn * hs.total
    if grid is None:
        grid = hs._b1.get((nch, dev.index))
        if grid is None:
            grid = hs._b1[(nch, dev.index)] = b1_grid(hs, nch, dev)
    stream = _raw_stream(dev.index)
    acc, ticket = _b1_accumulator(dev, stream, nh)
    out = torch.empty(nh + nch * hs.ndyn, dtype=torch.float32, device=dev)
    err = lib.sx_histogram(ctypes.byref(_b1_spec(hs)), nch, int(hs.weighted),
                           samples.data_ptr(), theta.data_ptr(),
                           theta.shape[-1], grid[0], grid[1], acc, ticket,
                           out.data_ptr(), stream)
    _check_cuda(lib, err, what)
    ndyn, total = hs.ndyn, hs.total
    if one:
        return (out.as_strided((ndyn, total), (total, 1)),
                out.as_strided((ndyn,), (1,), nh))
    return (out.as_strided((nch, ndyn, total), (ndyn * total, total, 1)),
            out.as_strided((nch, ndyn), (ndyn, 1), nh))


def segmented_histogram(hs: HistSpec, samples: torch.Tensor,
                        theta: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: ``(ndyn, total)`` float32 counts of the dynamic segments at
    systematic parameters ``theta`` and their ``(ndyn,)`` in-domain
    counts (the norms), both exact integer counts (weighted samples:
    float64 weight sums, rounded once).  One kernel launch."""
    _check_samples(hs, samples)
    _check_theta(hs, theta, 1, samples.device)
    if samples.device.type == "cpu":
        return segmented_histogram_plain(hs, samples, theta)
    out = _launch_histogram(hs, samples, theta, 1, "segmented_histogram",
                            one=True)
    _launched("segmented_histogram", hs)
    return out


def segmented_histogram_batched(hs: HistSpec, samples: torch.Tensor,
                                theta: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1, batched theta: ``(nchains, npar)`` parameter vectors ->
    ``(nchains, ndyn, total)`` counts and ``(nchains, ndyn)`` norms, from
    one read of the samples (each sample is loaded once and binned for
    every chain)."""
    _check_samples(hs, samples)
    _check_theta(hs, theta, 2, samples.device)
    nch = theta.shape[0]
    if not 1 <= nch <= MAXCHAINS:
        raise ValueError(f"{nch} chains (the kernel takes 1..{MAXCHAINS})")
    if samples.device.type == "cpu":
        return segmented_histogram_plain(hs, samples, theta)
    out = _launch_histogram(hs, samples, theta, nch,
                            "segmented_histogram_batched")
    _launched("segmented_histogram_batched", hs)
    return out


_F32, _Tensor = torch.float32, torch.Tensor

# B2's grid: blocks a row of the grid sized for this many blocks per SM,
# and the events a read-bin row from which a thread loads four int4s a
# tile instead of one (kLutThreads = 256 threads a block;
# csrc/sxmc_kernels.cu), as measured on an H100 (PERF.md).
LUT_BLOCKS_PER_SM = 4
LUT_WIDE_EVENTS = 65_536
_LUT_THREADS = 256


class _CLutPlan(ctypes.Structure):
    """Field-by-field mirror of ``SxLutPlan`` (csrc/sxmc_kernels.cu)."""

    _fields_ = [("rb", ctypes.c_void_p), ("nev", ctypes.c_longlong),
                ("rows", ctypes.c_int), ("nseg", ctypes.c_int),
                ("total", ctypes.c_int), ("staged", ctypes.c_int),
                ("vecs", ctypes.c_int), ("gx", ctypes.c_int),
                ("gy", ctypes.c_int), ("smem", ctypes.c_int),
                ("bin_volume", ctypes.c_float)]


def lut_form(total: int, nev: int, budget: int) -> Tuple[bool, int]:
    """B2's form for table rows of ``total`` bins and read-bin rows of
    ``nev`` events under a shared-memory ``budget`` in bytes: ``(staged,
    vecs)``.  Staged (each block stages its table row's quotients in
    shared memory) when a row's table fits the budget, else the L1 form
    (the counts read through L1, a division a value); a thread loads
    ``vecs`` int4s of read bins a tile: four from ``LUT_WIDE_EVENTS``
    events, else one (more blocks for a short row).  The rows that share
    a read-bin row do not change the form: each block writes one table
    row, the other rows' reads of its read bins hit L2."""
    return 4 * total <= budget, 4 if nev >= LUT_WIDE_EVENTS else 1


@functools.lru_cache(maxsize=None)
def _lut_limits(index: int) -> Tuple[int, int]:
    """(SMs, the shared memory a block may opt in to) of CUDA device
    ``index``."""
    lib = _library()
    nsm, smem = ctypes.c_int(0), ctypes.c_int(0)
    _check_cuda(lib, lib.sx_lut_limits(index, ctypes.byref(nsm),
                                       ctypes.byref(smem)), "lut_eval")
    return nsm.value, smem.value


@functools.lru_cache(maxsize=None)
def _lut_occupancy(index: int, staged: bool, vecs: int, smem: int) -> int:
    """Blocks of B2's form resident on one SM of device ``index`` (which
    is made current: the opt-in above 48 KB is set there)."""
    lib = _library()
    occ = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.sx_lut_occupancy(int(staged), vecs, smem,
                                   ctypes.byref(occ))
    _check_cuda(lib, err, "lut_eval")
    if occ.value < 1:
        raise RuntimeError(f"lut_eval: no block of {smem} bytes of shared "
                           "memory fits an SM")
    return occ.value


class _LutLaunch:
    """A plan's launch for one table shape: the C plan and its address,
    the output's and the norms' shapes, the C entry, the stream getter
    and a template of the output (one element expanded to its shape: no
    memory of its own, and ``torch.empty_like`` of it is a contiguous
    tensor by torch's shortest allocation path).  No C plan and no entry
    where nothing is launched (the CPU, an empty table)."""

    __slots__ = ("c", "addr", "shape", "norms_shape", "fn", "stream", "like")

    def __init__(self, c, shape, fn=None, stream=None, like=None):
        self.c, self.shape, self.norms_shape = c, shape, shape[:1]
        self.addr = None if c is None else ctypes.addressof(c)
        self.fn, self.stream, self.like = fn, stream, like


class LutPlan:
    """B2's plan for one read-bins tensor: ``plan(counts, norms)`` is
    :func:`lut_eval` ``(counts, norms, read_bins, bin_volume)``.

    The read bins (int32 ``(rows, nev)``, contiguous) and ``bin_volume``
    (used as float32) are checked once, here; the launch (form, grid and
    the C plan with its arguments) is made at the first call for each
    table shape ``(nseg, total)`` and kept.  A call checks ``counts`` and
    ``norms`` on one fast path, and only where that fails goes through
    :func:`lut_eval`'s checks, in its order, so that the same exceptions
    are raised.  On the CPU the plan runs :func:`lut_eval_plain`; on a
    card it launches the kernel (on the current stream of the read
    bins' device), never the plain version.  The plan holds the read
    bins.  ``blocks_per_sm`` sizes the grid and ``budget`` (bytes; the
    default: what a block may opt in to) picks the form
    (:func:`lut_form`): a probe or a check may set them (``budget=0``
    takes the L1 form at any shape)."""

    def __init__(self, read_bins: torch.Tensor, bin_volume: float,
                 blocks_per_sm: int = LUT_BLOCKS_PER_SM,
                 budget: Optional[int] = None):
        if read_bins.dim() != 2:
            raise ValueError("counts must be (nseg, total) and read_bins "
                             "(r, nevents)")
        self.read_bins = read_bins
        self.rows, self.nev = read_bins.shape
        self.device = read_bins.device
        _expect(read_bins, "read_bins", (self.rows, self.nev), torch.int32,
                self.device)
        self.bin_volume = float(np.float32(bin_volume))
        self.blocks_per_sm = int(blocks_per_sm)
        self.budget = budget
        # Tensor.get_device() of the read bins: -1 on the CPU.
        self._index = read_bins.get_device()
        self._launches = {}  # (nseg, total) -> _LutLaunch

    def __call__(self, counts: torch.Tensor,
                 norms: torch.Tensor) -> torch.Tensor:
        launch = (self._launches.get(counts.shape)
                  if type(counts) is _Tensor else None)
        index = self._index
        if (launch is None or type(norms) is not _Tensor
                or counts.dtype is not _F32 or norms.dtype is not _F32
                or counts.get_device() != index
                or norms.get_device() != index
                or norms.shape != launch.norms_shape
                or not counts.is_contiguous()
                or not norms.is_contiguous()):
            launch = self._check(counts, norms)
        if index < 0:
            return lut_eval_plain(counts, norms, self.read_bins,
                                  self.bin_volume)
        if launch.fn is None:  # nothing to write
            return torch.empty(launch.shape, dtype=_F32, device=self.device)
        out = torch.empty_like(launch.like)
        err = launch.fn(launch.addr, counts.data_ptr(), norms.data_ptr(),
                        out.data_ptr(), launch.stream(index))
        if err:
            _check_cuda(_library(), err, "lut_eval")
        _LAUNCHES["lut_eval"] += 1
        return out

    def _check(self, counts, norms) -> _LutLaunch:
        """:func:`lut_eval`'s checks of the table, in its order; the
        launch of its shape."""
        if counts.dim() != 2:
            raise ValueError("counts must be (nseg, total) and read_bins "
                             "(r, nevents)")
        nseg, total = counts.shape
        _expect(counts, "counts", (nseg, total), torch.float32, self.device)
        _expect(norms, "norms", (nseg,), torch.float32, self.device)
        if self.rows < 1 or nseg % self.rows:
            raise ValueError(f"{self.rows} read-bin rows do not divide "
                             f"{nseg} table rows")
        return self._launch(nseg, total)

    def _launch(self, nseg: int, total: int) -> _LutLaunch:
        """The launch of ``(nseg, total)`` tables, made at its first use:
        the form and the grid (one table row a block row; along x, blocks
        for the plan's blocks per SM, at most one a tile of the row, and
        from 8 tiles at least two tiles a block, so that its staging and
        first loads are paid once for both)."""
        key = (nseg, total)
        if key in self._launches:
            return self._launches[key]
        shape = (nseg, self.nev)
        if self._index < 0 or nseg == 0 or self.nev == 0:
            launch = _LutLaunch(None, shape)
        else:
            nsm, optin = _lut_limits(self._index)
            budget = optin if self.budget is None else min(optin,
                                                           self.budget)
            staged, vecs = lut_form(total, self.nev, budget)
            smem = 4 * total if staged else 0
            occ = _lut_occupancy(self._index, staged, vecs, smem)
            gy = min(nseg, 65535)
            int4s = -(-self.nev // 4)
            tiles = -(-int4s // (_LUT_THREADS * vecs))
            gx = min(tiles, -(-nsm * min(occ, self.blocks_per_sm) // gy))
            if tiles >= 8:
                gx = min(gx, -(-tiles // 2))
            c = _CLutPlan(self.read_bins.data_ptr(), self.nev, self.rows,
                          nseg, total, int(staged), vecs, max(gx, 1), gy,
                          smem, self.bin_volume)
            launch = _LutLaunch(
                c, shape, _library().sx_eval_lut,
                torch._C._cuda_getCurrentRawStream,
                torch.empty(1, dtype=_F32, device=self.device).expand(shape))
        self._launches[key] = launch
        return launch

    def form(self, nseg: int, total: int) -> Optional[dict]:
        """The launch of ``(nseg, total)`` tables: ``{"staged", "vecs",
        "grid", "smem"}``; None where nothing is launched (the CPU, an
        empty table)."""
        c = self._launch(nseg, total).c
        return None if c is None else {
            "staged": bool(c.staged), "vecs": c.vecs, "grid": (c.gx, c.gy),
            "smem": c.smem}


def lut_eval(counts: torch.Tensor, norms: torch.Tensor,
             read_bins: torch.Tensor, bin_volume: float) -> torch.Tensor:
    """B2: the ``(nseg, nev)`` float32 LUT ``counts[s, rb] / (norms[s] *
    bin_volume)``, -1 -> NaN (out of domain), -2 -> 0 (dataset
    mismatch).

    ``counts`` ``(nseg, total)`` and ``norms`` ``(nseg,)`` float32;
    ``read_bins`` int32 ``(r, nev)`` with ``nseg`` a multiple of r: row s
    reads read-bin row ``s % r`` (chains x signals rows share the
    signals' read bins without a copy).  ``bin_volume`` is used as
    float32, on both routes.  A caller that evaluates the same read bins
    again makes their :class:`LutPlan` once and calls it.
    """
    if counts.dim() != 2:  # the table before the read bins, as ever
        raise ValueError("counts must be (nseg, total) and read_bins "
                         "(r, nevents)")
    return LutPlan(read_bins, bin_volume)(counts, norms)


def _check_fused(hs, ns, samples, hist_init, rb, params, nch,
                 grouped: bool = False):
    """Inputs of B3/B4/B5: one dataset's ``(nsignals, nevents)`` read
    bins, or with ``grouped`` the ``(nexp, nsignals, nevents)`` of
    ``nexp`` experiments, nexp dividing the ``nch`` chains (the chain
    caps then hold per launch: :func:`_experiment_groups`)."""
    dev = samples.device
    ns.validate()
    _check_samples(hs, samples)
    _expect(hist_init, "hist_init", (ns.nsig, hs.total), torch.float32, dev)
    if grouped:
        if rb.dim() != 3 or not 1 <= rb.shape[0] <= nch \
                or nch % rb.shape[0]:
            raise ValueError(
                f"grouped read_bins must be (nexp, nsignals, nevents) with "
                f"nexp dividing the {nch} chains; got {tuple(rb.shape)}")
        _expect(rb, "read_bins", (rb.shape[0], ns.nsig, rb.shape[2]),
                torch.int32, dev)
    else:
        if rb.dim() != 2:
            raise ValueError("read_bins must be (nsignals, nevents)")
        _expect(rb, "read_bins", (ns.nsig, rb.shape[1]), torch.int32, dev)
    _expect(params, "params", (ns.npar,) if nch is None else (nch, ns.npar),
            torch.float32, dev)
    if sorted(s for s in ns.sig_slot if s >= 0) != list(range(hs.ndyn)):
        raise ValueError(f"sig_slot {ns.sig_slot} does not cover the "
                         f"{hs.ndyn} dynamic segments")
    if nch is not None and not grouped and not (
            1 <= nch <= MAXCHAINS and nch * ns.npar <= MAXCP
            and nch * ns.nsig <= MAXCS):
        raise ValueError(
            f"{nch} chains x {ns.npar} parameters x {ns.nsig} signals "
            f"(the kernels take up to {MAXCHAINS} chains, {MAXCP} "
            f"chain-parameters and {MAXCS} chain-signals)")


# The forms of sx_fused (csrc/sxmc_kernels.cu: SX_TRIL, SX_WEIGHTED,
# SX_TEMPERED).
_TRIL, _WEIGHTED, _TEMPERED = 1, 2, 4


def _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, width,
                  noise, log_u, nsteps, debug, samples_out, nlls_out,
                  acc_out, nch, what, kind="fused", nsub=0, beta=None,
                  cpe=0):
    """Launch B3/B4 (``kind`` "fused", "fused_tril" for the tril
    proposals, "fused_tempered" with ``beta``) or B5 ("blocked", ``nsub``
    decisions per cycle) on the grid that the library's rule picks; the
    weighted forms for weighted samples, the experiment-grouped forms
    for ``cpe`` > 0 chains per experiment (``rb`` ``(nch // cpe, nsig,
    nev)``)."""
    dev = samples.device
    lib = _library()
    cs = _c_spec(hs, ns, int(ns.st.nsources))
    nblocks = ctypes.c_int(0)
    if kind == "blocked":
        err = lib.sx_blocked_grid(ctypes.byref(cs), nch,
                                  ctypes.byref(nblocks))
    else:
        err = lib.sx_fused_grid(ctypes.byref(cs), nch, int(hs.weighted),
                                ctypes.byref(nblocks))
    _check_cuda(lib, err, what)
    # B5 double-buffers its partials by decision parity.
    nslots = nch * nblocks.value * (2 if kind == "blocked" else 1)
    partials = torch.empty(nslots, dtype=torch.float64, device=dev)
    scratch = torch.empty(2 * nch * (hs.ndyn * hs.total + hs.ndyn),
                          dtype=_acc_dtype(hs), device=dev)
    tail = (int(debug), _ptr(scratch), _ptr(partials), nblocks.value,
            _ptr(samples_out), _ptr(nlls_out), _ptr(acc_out),
            _raw_stream(dev.index))
    nev = rb.shape[-1]
    if kind == "blocked":
        err = lib.sx_blocked(
            ctypes.byref(cs), nch, cpe, _ptr(samples), _ptr(hist_init),
            _ptr(rb), nev, _ptr(params0), _ptr(nll0), _ptr(width),
            _ptr(noise), _ptr(log_u), nsteps, nsub, *tail)
    else:
        form = ((_TRIL if kind == "fused_tril" else 0)
                | (_TEMPERED if kind == "fused_tempered" else 0)
                | (_WEIGHTED if hs.weighted else 0))
        err = lib.sx_fused(
            ctypes.byref(cs), nch, cpe, form, _ptr(samples),
            _ptr(hist_init), _ptr(rb), nev, _ptr(params0), _ptr(nll0),
            _ptr(width), _ptr(beta), _ptr(noise), _ptr(log_u), nsteps, *tail)
    _check_cuda(lib, err, what)


def fused_nll(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
              hist_init: torch.Tensor, rb: torch.Tensor,
              params: torch.Tensor):
    """B3: the compensated NLL ``(hi, lo)`` at ``params`` in one
    launch: rebuild the dynamic histograms on top of the static rows,
    norms, LUT gather, mix, log-sum, finish."""
    _check_fused(hs, ns, samples, hist_init, rb, params, None)
    if samples.device.type == "cpu":
        return fused_nll_plain(hs, ns, samples, hist_init, rb, params)
    out = torch.empty(2, dtype=torch.float32, device=samples.device)
    _launch_fused(hs, ns, samples, hist_init, rb, params, None, None, None,
                  None, 0, False, None, out, None, 1, "fused_nll")
    _launched("fused_nll", hs)
    return out[0], out[1]


def fused_nll_batched(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                      hist_init: torch.Tensor, rb: torch.Tensor,
                      params: torch.Tensor):
    """B3, batched: ``(nchains, npar)`` params -> ``(hi (nchains,), lo
    (nchains,))``, every chain from one read of each sample."""
    nch = params.shape[0]
    _check_fused(hs, ns, samples, hist_init, rb, params, nch)
    if samples.device.type == "cpu":
        return fused_nll_plain(hs, ns, samples, hist_init, rb, params)
    out = torch.empty((nch, 2), dtype=torch.float32, device=samples.device)
    _launch_fused(hs, ns, samples, hist_init, rb, params, None, None, None,
                  None, 0, False, None, out, None, nch, "fused_nll_batched")
    _launched("fused_nll_batched", hs)
    return out[:, 0], out[:, 1]


def _check_segment(ns, params0, nll0, width, noise, log_u, nch,
                   tril=False, blocked=False):
    """Shapes of a segment's inputs: ``width`` ``([nch,] npar)``, or
    ``([nch,] npar, npar)`` with ``tril``; ``noise`` ``(n, [nsub,] [nch,]
    npar)`` and ``log_u`` ``(n, [nsub,] [nch])``, the ``nsub`` axis of
    decisions per cycle when ``blocked`` (B5).  Returns ``(n, nsub)``."""
    dev = params0.device
    lead = () if nch is None else (nch,)
    sub = (noise.shape[1] if noise.dim() > 1 else -1,) if blocked else ()
    n = noise.shape[0] if noise.dim() == 2 + len(sub + lead) else -1
    _expect(nll0, "nll0", lead + (2,), torch.float32, dev)
    _expect(width, "width", lead + (ns.npar,) * (2 if tril else 1),
            torch.float32, dev)
    _expect(noise, "noise", (n,) + sub + lead + (ns.npar,), torch.float32,
            dev)
    _expect(log_u, "log_u", (n,) + sub + lead, torch.float32, dev)
    if n < 1:
        raise ValueError("a segment needs at least one step")
    if sub and sub[0] < 2:
        raise ValueError("a blocked cycle needs at least one rate move "
                         f"(noise has {sub[0]} decisions per cycle)")
    return n, (sub[0] if sub else None)


def _segment_out(n, lead, npar, dev):
    """A segment's empty histories: samples, NLL pairs, accepts."""
    return (torch.empty((n,) + lead + (npar,), dtype=torch.float32,
                        device=dev),
            torch.empty((n,) + lead + (2,), dtype=torch.float32, device=dev),
            torch.empty((n,) + lead, dtype=torch.float32, device=dev))


def fused_segment(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                  hist_init: torch.Tensor, rb: torch.Tensor,
                  params0: torch.Tensor, nll0: torch.Tensor,
                  width: torch.Tensor, noise: torch.Tensor,
                  log_u: torch.Tensor, debug_mode: bool = False):
    """B4: a whole fixed-width Metropolis segment in one launch.

    Per step: propose ``cur + noise * max(width, 0)`` (pinned where
    width <= 0), B3's NLL, accept where ``delta > 0`` or ``log_u <=
    delta``.  Returns the scan-shaped history ``(samples (n, npar),
    nlls (n, 2), accepts (n,))``.
    """
    dev = samples.device
    _check_fused(hs, ns, samples, hist_init, rb, params0, None)
    n, _ = _check_segment(ns, params0, nll0, width, noise, log_u, None)
    if dev.type == "cpu":
        return fused_segment_plain(hs, ns, samples, hist_init, rb, params0,
                                   nll0, width, noise, log_u, debug_mode)
    out = _segment_out(n, (), ns.npar, dev)
    _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, width,
                  noise, log_u, n, debug_mode, *out, 1, "fused_segment")
    _launched("fused_segment", hs)
    return out


def fused_segment_batched(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                          hist_init: torch.Tensor, rb: torch.Tensor,
                          params0: torch.Tensor, nll0: torch.Tensor,
                          width: torch.Tensor, noise: torch.Tensor,
                          log_u: torch.Tensor, debug_mode: bool = False):
    """B4, lock-step chains: ``params0 (nchains, npar)``, ``nll0
    (nchains, 2)``, ``width (nchains, npar)``, ``noise (n, nchains,
    npar)``, ``log_u (n, nchains)`` -> histories ``(n, nchains, npar)``,
    ``(n, nchains, 2)``, ``(n, nchains)`` (pallas_step.py:882-903).
    Each chain decides as :func:`fused_segment` would alone."""
    dev = samples.device
    nch = params0.shape[0]
    _check_fused(hs, ns, samples, hist_init, rb, params0, nch)
    n, _ = _check_segment(ns, params0, nll0, width, noise, log_u, nch)
    if dev.type == "cpu":
        return fused_segment_plain(hs, ns, samples, hist_init, rb, params0,
                                   nll0, width, noise, log_u, debug_mode)
    out = _segment_out(n, (nch,), ns.npar, dev)
    _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, width,
                  noise, log_u, n, debug_mode, *out, nch,
                  "fused_segment_batched")
    _launched("fused_segment_batched", hs)
    return out


def fused_segment_tril(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                       hist_init: torch.Tensor, rb: torch.Tensor,
                       params0: torch.Tensor, nll0: torch.Tensor,
                       tril: torch.Tensor, noise: torch.Tensor,
                       log_u: torch.Tensor, debug_mode: bool = False):
    """B4 with full-covariance proposals: as :func:`fused_segment`, each
    step proposing ``cur + L @ z`` with the lower-triangular ``tril``
    ``(npar, npar)`` (only ``j <= k`` is read; zero rows pin a
    parameter), summed in the order of :func:`tril_propose_plain`."""
    dev = samples.device
    _check_fused(hs, ns, samples, hist_init, rb, params0, None)
    n, _ = _check_segment(ns, params0, nll0, tril, noise, log_u, None,
                          tril=True)
    if dev.type == "cpu":
        return fused_segment_plain(hs, ns, samples, hist_init, rb, params0,
                                   nll0, tril, noise, log_u, debug_mode)
    out = _segment_out(n, (), ns.npar, dev)
    _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, tril,
                  noise, log_u, n, debug_mode, *out, 1,
                  "fused_segment_tril", kind="fused_tril")
    _launched("fused_segment_tril", hs)
    return out


def fused_segment_tril_batched(hs: HistSpec, ns: NLLSpec,
                               samples: torch.Tensor,
                               hist_init: torch.Tensor, rb: torch.Tensor,
                               params0: torch.Tensor, nll0: torch.Tensor,
                               tril: torch.Tensor, noise: torch.Tensor,
                               log_u: torch.Tensor,
                               debug_mode: bool = False):
    """:func:`fused_segment_tril` for lock-step chains: ``tril``
    ``(nchains, npar, npar)``, one per chain, the rest as
    :func:`fused_segment_batched`."""
    dev = samples.device
    nch = params0.shape[0]
    _check_fused(hs, ns, samples, hist_init, rb, params0, nch)
    n, _ = _check_segment(ns, params0, nll0, tril, noise, log_u, nch,
                          tril=True)
    if dev.type == "cpu":
        return fused_segment_plain(hs, ns, samples, hist_init, rb, params0,
                                   nll0, tril, noise, log_u, debug_mode)
    out = _segment_out(n, (nch,), ns.npar, dev)
    _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, tril,
                  noise, log_u, n, debug_mode, *out, nch,
                  "fused_segment_tril_batched", kind="fused_tril")
    _launched("fused_segment_tril_batched", hs)
    return out


def fused_segment_tempered(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                           hist_init: torch.Tensor, rb: torch.Tensor,
                           params0: torch.Tensor, nll0: torch.Tensor,
                           width: torch.Tensor, beta: torch.Tensor,
                           noise: torch.Tensor, log_u: torch.Tensor,
                           debug_mode: bool = False):
    """B4 for a parallel-tempering ladder: the lock-step replicas of
    :func:`fused_segment_batched` (``params0`` ``(ntemps, npar)``), each
    replica c deciding with ``delta = beta[c] * df_diff(...)``
    (pallas_step.py:782-786) against ``beta`` ``(ntemps,)`` float32,
    every entry > 0.  The caller widens each replica's ``width`` row by
    1/sqrt(beta) (mcmc/tempered.py)."""
    dev = samples.device
    nch = params0.shape[0]
    _check_fused(hs, ns, samples, hist_init, rb, params0, nch)
    n, _ = _check_segment(ns, params0, nll0, width, noise, log_u, nch)
    _expect(beta, "beta", (nch,), torch.float32, dev)
    if dev.type == "cpu":
        return fused_segment_plain(hs, ns, samples, hist_init, rb, params0,
                                   nll0, width, noise, log_u, debug_mode,
                                   beta)
    out = _segment_out(n, (nch,), ns.npar, dev)
    _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, width,
                  noise, log_u, n, debug_mode, *out, nch,
                  "fused_segment_tempered", kind="fused_tempered",
                  beta=beta)
    _launched("fused_segment_tempered", hs)
    return out


def blocked_segment(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                    hist_init: torch.Tensor, rb: torch.Tensor,
                    params0: torch.Tensor, nll0: torch.Tensor,
                    width: torch.Tensor, noise: torch.Tensor,
                    log_u: torch.Tensor, debug_mode: bool = False):
    """B5: a whole blocked Metropolis-within-Gibbs segment of one chain
    in one launch.

    ``noise`` ``(n, M + 1, npar)`` and ``log_u`` ``(n, M + 1)``, M >= 1:
    per cycle, row 0 drives the systematic-block move (every parameter
    but the rates; a rebuild), rows 1..M the rate-block moves, scored
    against the carried current histogram.  Accept where ``delta > 0``
    or ``log_u <= delta``.  Returns ``(samples (n, npar), nlls (n, 2),
    accepted fraction (n,))`` per cycle.
    """
    dev = samples.device
    _check_fused(hs, ns, samples, hist_init, rb, params0, None)
    _check_unweighted(hs)
    n, nsub = _check_segment(ns, params0, nll0, width, noise, log_u, None,
                             blocked=True)
    if dev.type == "cpu":
        return blocked_segment_plain(hs, ns, samples, hist_init, rb,
                                     params0, nll0, width, noise, log_u,
                                     debug_mode)
    out = _segment_out(n, (), ns.npar, dev)
    _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, width,
                  noise, log_u, n, debug_mode, *out, 1, "blocked_segment",
                  kind="blocked", nsub=nsub)
    _launched("blocked_segment")
    return out


def blocked_segment_batched(hs: HistSpec, ns: NLLSpec,
                            samples: torch.Tensor, hist_init: torch.Tensor,
                            rb: torch.Tensor, params0: torch.Tensor,
                            nll0: torch.Tensor, width: torch.Tensor,
                            noise: torch.Tensor, log_u: torch.Tensor,
                            debug_mode: bool = False):
    """B5, lock-step chains: ``params0`` and ``width`` ``(nchains,
    npar)``, ``nll0`` ``(nchains, 2)``, ``noise`` ``(n, M + 1, nchains,
    npar)``, ``log_u`` ``(n, M + 1, nchains)`` (pallas_step.py:1287-1292)
    -> histories ``(n, nchains, ...)``.  Each chain decides as
    :func:`blocked_segment` would alone."""
    dev = samples.device
    nch = params0.shape[0]
    _check_fused(hs, ns, samples, hist_init, rb, params0, nch)
    _check_unweighted(hs)
    n, nsub = _check_segment(ns, params0, nll0, width, noise, log_u, nch,
                             blocked=True)
    if dev.type == "cpu":
        return blocked_segment_plain(hs, ns, samples, hist_init, rb,
                                     params0, nll0, width, noise, log_u,
                                     debug_mode)
    out = _segment_out(n, (nch,), ns.npar, dev)
    _launch_fused(hs, ns, samples, hist_init, rb, params0, nll0, width,
                  noise, log_u, n, debug_mode, *out, nch,
                  "blocked_segment_batched", kind="blocked", nsub=nsub)
    _launched("blocked_segment_batched")
    return out


def _experiment_groups(ns: NLLSpec, nexp: int, cpe: int):
    """The launches of a grouped batch: ``[(first, end)]`` experiment
    ranges, each as many whole experiments of ``cpe`` chains as the
    kernels' caps take (chains, chains x parameters, chains x
    signals)."""
    per = min(MAXCHAINS // cpe, MAXCP // (cpe * ns.npar),
              MAXCS // (cpe * ns.nsig))
    if per < 1:
        raise ValueError(
            f"{cpe} chains per experiment x {ns.npar} parameters x "
            f"{ns.nsig} signals exceed one launch (the kernels take up to "
            f"{MAXCHAINS} chains, {MAXCP} chain-parameters and {MAXCS} "
            f"chain-signals)")
    return [(e, min(e + per, nexp)) for e in range(0, nexp, per)]


def _segment_grouped(name, kind, hs, ns, samples, hist_init, rb, params0,
                     nll0, width, noise, log_u, debug_mode):
    """The grouped forms' shared body: check, then the plain version on
    the CPU, or one launch per group of whole experiments (one for the
    whole batch when it fits; each launch counts once)."""
    dev = samples.device
    nch = params0.shape[0]
    blocked = kind == "blocked"
    _check_fused(hs, ns, samples, hist_init, rb, params0, nch, grouped=True)
    if blocked:
        _check_unweighted(hs)
    n, nsub = _check_segment(ns, params0, nll0, width, noise, log_u, nch,
                             tril=kind == "fused_tril", blocked=blocked)
    nexp = rb.shape[0]
    cpe = nch // nexp
    groups = _experiment_groups(ns, nexp, cpe)
    if dev.type == "cpu":
        plain = (blocked_segment_grouped_plain if blocked
                 else fused_segment_grouped_plain)
        return plain(hs, ns, samples, hist_init, rb, params0, nll0, width,
                     noise, log_u, debug_mode)
    axis = 2 if blocked else 1  # the chain axis of noise and log_u
    outs = []
    for e0, e1 in groups:
        c0, c1 = e0 * cpe, e1 * cpe

        def part(t, dim=0):
            if len(groups) == 1:
                return t
            return t.narrow(dim, c0, c1 - c0).contiguous()

        out = _segment_out(n, (c1 - c0,), ns.npar, dev)
        _launch_fused(hs, ns, samples, hist_init, rb[e0:e1], part(params0),
                      part(nll0), part(width), part(noise, axis),
                      part(log_u, axis), n, debug_mode, *out, c1 - c0, name,
                      kind=kind, nsub=nsub or 0, cpe=cpe)
        _launched(name, hs)
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(3))


def fused_segment_grouped(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                          hist_init: torch.Tensor, rb: torch.Tensor,
                          params0: torch.Tensor, nll0: torch.Tensor,
                          width: torch.Tensor, noise: torch.Tensor,
                          log_u: torch.Tensor, debug_mode: bool = False):
    """B4, experiment-grouped (pallas_step.py:889-933): the lock-step
    chains of :func:`fused_segment_batched` (``params0 (nch, npar)``,
    ``noise (n, nch, npar)``, ...) over ``nexp`` experiments' read bins
    ``rb (nexp, nsig, nev)``, ``nch = nexp * cpe`` chain-major by
    experiment: chain c scores experiment c // cpe's events.  Each chain
    decides as :func:`fused_segment_batched` would on its experiment's
    rows; pad rows (sentinel read bins) add exactly 0."""
    return _segment_grouped("fused_segment_grouped", "fused", hs, ns,
                            samples, hist_init, rb, params0, nll0, width,
                            noise, log_u, debug_mode)


def fused_segment_tril_grouped(hs: HistSpec, ns: NLLSpec,
                               samples: torch.Tensor,
                               hist_init: torch.Tensor, rb: torch.Tensor,
                               params0: torch.Tensor, nll0: torch.Tensor,
                               tril: torch.Tensor, noise: torch.Tensor,
                               log_u: torch.Tensor,
                               debug_mode: bool = False):
    """:func:`fused_segment_grouped` with full-covariance proposals,
    ``tril`` ``(nch, npar, npar)`` (B4's grouped tril form)."""
    return _segment_grouped("fused_segment_tril_grouped", "fused_tril", hs,
                            ns, samples, hist_init, rb, params0, nll0, tril,
                            noise, log_u, debug_mode)


def blocked_segment_grouped(hs: HistSpec, ns: NLLSpec, samples: torch.Tensor,
                            hist_init: torch.Tensor, rb: torch.Tensor,
                            params0: torch.Tensor, nll0: torch.Tensor,
                            width: torch.Tensor, noise: torch.Tensor,
                            log_u: torch.Tensor, debug_mode: bool = False):
    """B5, experiment-grouped (pallas_step.py:1307-1360): the chains of
    :func:`blocked_segment_batched` (``noise (n, M + 1, nch, npar)``)
    over ``rb (nexp, nsig, nev)``, chain c scoring experiment c // cpe's
    events in every move.  Unweighted stacks only."""
    return _segment_grouped("blocked_segment_grouped", "blocked", hs, ns,
                            samples, hist_init, rb, params0, nll0, width,
                            noise, log_u, debug_mode)


def _check_unweighted(hs: HistSpec) -> None:
    if hs.weighted:
        raise ValueError("the blocked kernel B5 takes unweighted samples "
                         "(its rate moves reuse integer in-domain counts; "
                         "weighted blocked fits take the stepper)")


# Every form, by the name its launches count under.
FORMS = (
    "segmented_histogram", "segmented_histogram_weighted",
    "segmented_histogram_batched", "segmented_histogram_batched_weighted",
    "lut_eval",
    "fused_nll", "fused_nll_weighted",
    "fused_nll_batched", "fused_nll_batched_weighted",
    "fused_segment", "fused_segment_weighted",
    "fused_segment_batched", "fused_segment_batched_weighted",
    "fused_segment_tril", "fused_segment_tril_weighted",
    "fused_segment_tril_batched", "fused_segment_tril_batched_weighted",
    "fused_segment_tempered", "fused_segment_tempered_weighted",
    "fused_segment_grouped", "fused_segment_grouped_weighted",
    "fused_segment_tril_grouped", "fused_segment_tril_grouped_weighted",
    "blocked_segment", "blocked_segment_batched", "blocked_segment_grouped",
)
_LAUNCHES = dict.fromkeys(FORMS, 0)


def _launched(name: str, hs: Optional[HistSpec] = None) -> None:
    """Count one launch of wrapper ``name``'s kernel, under its weighted
    form's name for weighted samples."""
    _LAUNCHES[name + ("_weighted" if hs is not None and hs.weighted
                      else "")] += 1


def launch_counts() -> dict:
    """Launches of each kernel and form since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
