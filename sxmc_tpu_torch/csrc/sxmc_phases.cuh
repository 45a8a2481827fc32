// Shared device code of the sxmc_tpu_torch kernels (Hopper, sm_90a).
//
// The phase functions below are used by the fused NLL / whole-segment
// kernel (B3/B4, every form) and the blocked whole-segment kernel (B5),
// the way sxmc_tpu/ops/pallas_step.py::_phase_bodies shares its bodies
// between pallas_fused_step, pallas_fused_segment and
// pallas_fused_segment_blocked: one copy of the systematics and bin-id
// math, the event sweep and the NLL finish, so a proposal is binned and
// scored identically by every kernel.  The segmented histogram B1
// (sxmc_hist.cu) is a one-shot pass over device memory with its own
// loop, and repeats the same float operations in the same order.
//
// Arithmetic contract: every float operation is the JAX package's, in
// its order, in float32, and the library is built with -fmad=false so
// that nvcc contracts no a*b+c into an FMA.  floor((x - lo) * scale)
// is rounding-sensitive; an FMA would move samples that sit on a bin
// edge into the neighbouring bin.
//
// Weighted MC samples (kW): the samples carry one more row, the per-
// sample float32 weight, after the nfields fields.  Bins and in-domain
// norms then accumulate the weights in float64 (SxAcc<true>), in shared
// and global memory alike, and are rounded once to float32 where they
// are read.  Float atomics land in scheduling order, so a float32 sum
// would differ from run to run; in float64 the order moves a sum by
// ~1e-16 relative, and the rounded float32 value is the same except
// where the sum falls on a float32 rounding tie.  Unweighted counts stay
// unsigned integers: exact in any order.

#pragma once

#include <cstdint>
#include <type_traits>

#define SX_MAXOBS 4
#define SX_MAXFIELDS 8
#define SX_MAXSEG 32
#define SX_MAXSIG 32
#define SX_MAXSYST 8
#define SX_MAXPOW 4
#define SX_MAXPAR 64
#define SX_MAXCHAINS 32  // lock-step chains of one launch (every
                         // experiment's, in the grouped forms)
#define SX_MAXCP 512     // chains x parameters
#define SX_MAXCS 256     // chains x signals
#define SX_THREADS 256

#define SX_SHIFT 0
#define SX_SCALE 1
#define SX_RESOLUTION_SCALE 2
#define SX_CTSCALE 3

// Everything static about one fit, passed to the kernels by value.
// Mirrored field by field by sxmc_tpu_torch/ops/kernels.py::_CSpec
// (every member is 4 bytes, so there is no padding).
struct SxSpec {
  // Sample layout and binning.
  int nfields;
  int nobs;
  int nload;     // fields held in registers: the observables, then the
                 // fields after them that a systematic transforms
  int total;     // total bins
  int ndyn;      // dynamic segments (signals some systematic acts on)
  int nsyst;
  int nbins[SX_MAXOBS];
  int strides[SX_MAXOBS];
  int seg_off[SX_MAXSEG + 1];  // sample offsets of the dynamic segments
  int syst_type[SX_MAXSYST];
  int syst_obs[SX_MAXSYST];
  int syst_extra[SX_MAXSYST];
  int syst_npow[SX_MAXSYST];
  int syst_par[SX_MAXSYST * SX_MAXPOW];  // index into the parameter vector
  unsigned syst_mask[SX_MAXSYST];        // bit d: acts on segment d
  float lower[SX_MAXOBS];
  float upper[SX_MAXOBS];
  float scale[SX_MAXOBS];  // f32(nbins) / (f32(upper) - f32(lower))
  // Likelihood (B3/B4 only).
  int nsig;
  int npar;
  int nsources;
  int sig_slot[SX_MAXSIG];   // dynamic segment of signal j, or -1 (static)
  int source_id[SX_MAXSIG];
  float bin_volume;
  float nexpected[SX_MAXSIG];
  float n_mc[SX_MAXSIG];
  float norm_init[SX_MAXSIG];  // in-domain count of static signals
  float means[SX_MAXPAR];
  float sigmas[SX_MAXPAR];
};

// The accumulator of a histogram cell or an in-domain norm: unsigned
// counts, or float64 sums of weights.
template <bool kW>
using SxAcc = typename std::conditional<kW, double, unsigned>::type;

// Sum of v over the warp (every lane must call it).
__device__ __forceinline__ double sx_warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The value of a[i] for a runtime i < N, with a held in registers (a
// chain of selects: indexing a register array at run time would put
// it in local memory).
template <int N>
__device__ __forceinline__ float sx_pick(const float (&a)[N], int i) {
  float v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = (i == j) ? a[j] : v;
  return v;
}

// Systematic types whose transform reads a second field (the switch
// in sx_bin_row sends every other type to the resolution form).
__host__ __device__ __forceinline__ bool sx_reads_extra(int type) {
  return type != SX_SHIFT && type != SX_SCALE && type != SX_CTSCALE;
}

// Load what binning sample i (of dynamic segment seg) reads: its
// first nload fields (field-major: field f of sample i is
// samples[f * n + i]), the observables and the fields after them that a
// systematic transforms, into x; and into xe[k] the second field of
// each masked resolution systematic k whose second field is not among
// them (one that is is read after the earlier systematics moved it, in
// sx_bin_row).  Other fields are never read.  kNobs is 1 (nload == 1:
// one observable, no other field transformed), SX_MAXOBS (nload up to
// 4) or SX_MAXFIELDS (any nload: a systematic may transform any sample
// field, as in the JAX package), the unused entries left at 0.
template <int kNobs>
__device__ __forceinline__ void sx_load_row(const SxSpec& sp,
                                            const float* __restrict__ samples,
                                            long long n, long long i, int seg,
                                            float (&x)[kNobs],
                                            float (&xe)[SX_MAXSYST]) {
#pragma unroll
  for (int a = 0; a < kNobs; ++a)
    x[a] = (kNobs == 1 || a < sp.nload) ? samples[a * n + i] : 0.0f;
#pragma unroll
  for (int k = 0; k < SX_MAXSYST; ++k) {
    xe[k] = 0.0f;
    if (k < sp.nsyst && ((sp.syst_mask[k] >> seg) & 1u) &&
        sx_reads_extra(sp.syst_type[k]) && sp.syst_extra[k] >= sp.nload)
      xe[k] = samples[sp.syst_extra[k] * n + i];
  }
}

// The flat bin id of one sample (of dynamic segment seg) after the
// masked systematics at parameters par, or -1 when it is out of
// domain; x and xe as sx_load_row loaded them (x is a copy: each chain
// transforms its own).  Every loop runs over a compile-time bound with
// the spec's counts as uniform guards, so that x and xe stay in
// registers and the spec's entries are constant operands.
template <int kNobs>
__device__ __forceinline__ int sx_bin_row(const SxSpec& sp, float (&x)[kNobs],
                                          const float (&xe)[SX_MAXSYST],
                                          int seg, const float* par) {
#pragma unroll
  for (int k = 0; k < SX_MAXSYST; ++k) {
    if (k >= sp.nsyst) break;
    if (!((sp.syst_mask[k] >> seg) & 1u)) continue;
    const int o = kNobs == 1 ? 0 : sp.syst_obs[k];
    const float xo = sx_pick(x, o);
    float p = 0.0f;
    float xi = 1.0f;
#pragma unroll
    for (int q = 0; q < SX_MAXPOW; ++q) {
      if (q >= sp.syst_npow[k]) break;
      if (q > 0) xi = xi * xo;
      p = p + par[sp.syst_par[k * SX_MAXPOW + q]] * xi;
    }
    float nw;
    switch (sp.syst_type[k]) {
      case SX_SHIFT: nw = xo + p; break;
      case SX_SCALE: nw = xo * (1.0f + p); break;
      case SX_CTSCALE: nw = 1.0f + (xo - 1.0f) * (1.0f + p); break;
      default: {
        const int e = sp.syst_extra[k];
        const float xt = e < sp.nload ? sx_pick(x, e) : xe[k];
        nw = xo + p * (xo - xt);
      }
    }
#pragma unroll
    for (int a = 0; a < kNobs; ++a)
      if (a == o) x[a] = nw;
  }
  // The observables are the first nobs <= SX_MAXOBS fields.
  constexpr int kBin = kNobs < SX_MAXOBS ? kNobs : SX_MAXOBS;
  int id = 0;
#pragma unroll
  for (int a = 0; a < kBin; ++a) {
    if (a >= sp.nobs) break;
    const float v = x[a];
    if (!(v >= sp.lower[a] && v < sp.upper[a])) return -1;
    int ax = (int)floorf((v - sp.lower[a]) * sp.scale[a]);
    ax = min(max(ax, 0), sp.nbins[a] - 1);
    id += ax * sp.strides[a];
  }
  return id;
}

// Histogram this block's share of every dynamic segment, for nchains
// parameter vectors (chain c's at par + c * pstride).  Counts go to the
// block's shared-memory replicas (warp w uses replica w % nrep, which
// divides the contention of few-bin histograms), or straight to global
// memory when nrep == 0 (histograms too large for shared memory).
// Histogram layout, in a replica and in global memory alike: (nchains,
// ndyn, total); in-domain counts go to sh_norm (nchains, ndyn).
// Unsigned integer counts: exact, whatever order the atomics land in.
// Weighted (kW): each in-domain sample adds its weight (row nfields of
// the samples) in float64 instead of 1.
//
// One chain: each thread bins its samples and counts its in-domain
// ones, one warp sum per segment.  Lock-step chains: each sample's
// observables are loaded once into registers and binned for every
// chain.  An in-domain sample lands in exactly one bin, so with
// replicas a chain's in-domain counts are the sums of its bins, taken
// once a step in sx_flush<true>; without replicas (every count a global
// atomic) the loop is warp-uniform and one ballot per chain and sample
// row counts them (weighted: a warp sum of their weights).  Measured
// on an H100 at 8 chains, the rebuild is bound by the binning's
// instructions, not by the shared atomics' address conflicts: warp-
// aggregated counts (ballots per bin, __match_any_sync, __reduce_add_sync
// of packed one-hot counters) were each slower than one atomic a
// binning.  The kernels are instantiated once per form (kChains, kW),
// and the binning once for one field in registers (nload == 1) and once
// for several: measured on an H100, the general binning run at one
// observable took 17% longer a B4 step with one chain and 36% with 8.
// A layout whose systematics transform a field past the fourth takes
// kernels of its own (kWide) whose binning holds SX_MAXFIELDS fields.
//
// kOff (the blocked kernel B5, unweighted): chain c's global histogram
// starts at g_hist + choff[c] instead of g_hist + c * ndyn * total, so
// that each chain can rebuild into whichever of its two buffers is not
// current.
template <int kNobs, bool kChains, bool kOff, bool kW>
__device__ __forceinline__ void sx_accumulate_obs(
    const SxSpec& sp, const float* __restrict__ samples, const float* par,
    int nchains, int pstride, SxAcc<kW>* sh_hist, SxAcc<kW>* sh_norm,
    SxAcc<kW>* g_hist, int nrep, const int* choff) {
  using Acc = SxAcc<kW>;
  const long long n = sp.seg_off[sp.ndyn];
  const float* __restrict__ wrow = samples + (long long)sp.nfields * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // One pointer for both (generic atomics): measured on an H100, the
  // lock-step rebuild took longer with a branch to shared-memory and
  // global atomics.
  Acc* mine =
      nrep ? sh_hist + (warp % nrep) * nchains * sp.ndyn * sp.total : g_hist;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int seg = 0; seg < sp.ndyn; ++seg) {
    const long long end = sp.seg_off[seg + 1];
    if constexpr (!kChains) {
      Acc cnt = 0;
      Acc* row = mine + seg * sp.total;
      if constexpr (kOff) {
        if (!nrep) row = g_hist + choff[0] + seg * sp.total;
      }
      for (long long i = sp.seg_off[seg] +
                         (long long)blockIdx.x * blockDim.x + threadIdx.x;
           i < end; i += stride) {
        float x[kNobs];
        float xe[SX_MAXSYST];
        sx_load_row<kNobs>(sp, samples, n, i, seg, x, xe);
        const int id = sx_bin_row<kNobs>(sp, x, xe, seg, par);
        if (id >= 0) {
          Acc one;
          if constexpr (kW) {
            one = (double)wrow[i];
          } else {
            one = 1u;
          }
          cnt += one;
          atomicAdd(&row[id], one);
        }
      }
      if constexpr (kW) {
        cnt = sx_warp_sum(cnt);
        if (lane == 0 && cnt != 0.0) atomicAdd(&sh_norm[seg], cnt);
      } else {
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (lane == 0 && cnt) atomicAdd(&sh_norm[seg], cnt);
      }
    } else {
      const long long first =
          (long long)blockIdx.x * blockDim.x + (warp << 5);
      for (long long base = sp.seg_off[seg] + first; base < end;
           base += stride) {
        const long long i = base + lane;
        const bool live = i < end;
        float x0[kNobs];
        float xe[SX_MAXSYST];
        sx_load_row<kNobs>(sp, samples, n, live ? i : base, seg, x0, xe);
        Acc one;
        if constexpr (kW) {
          one = live ? (double)wrow[i] : 0.0;
        } else {
          one = 1u;
        }
        for (int c = 0; c < nchains; ++c) {
          int id = -1;
          if (live) {
            float x[kNobs];
#pragma unroll
            for (int a = 0; a < kNobs; ++a) x[a] = x0[a];
            id = sx_bin_row<kNobs>(sp, x, xe, seg, par + c * pstride);
          }
          if (id >= 0) {
            if constexpr (kOff) {
              atomicAdd(nrep ? &mine[(c * sp.ndyn + seg) * sp.total + id]
                             : &g_hist[choff[c] + seg * sp.total + id],
                        one);
            } else {
              atomicAdd(&mine[(c * sp.ndyn + seg) * sp.total + id], one);
            }
          }
          if (!nrep) {  // warp-uniform
            const unsigned hit = __ballot_sync(0xffffffffu, id >= 0);
            if constexpr (kW) {
              if (hit) {
                const double v = sx_warp_sum(id >= 0 ? one : 0.0);
                if (lane == 0) atomicAdd(&sh_norm[c * sp.ndyn + seg], v);
              }
            } else {
              if (lane == 0 && hit)
                atomicAdd(&sh_norm[c * sp.ndyn + seg],
                          (unsigned)__popc(hit));
            }
          }
        }
      }
    }
  }
}

// kWide: the binning of up to SX_MAXFIELDS fields (nload > SX_MAXOBS)
// alone; else the one-field or the four-field binning, by nload.
template <bool kChains, bool kOff = false, bool kW = false,
          bool kWide = false>
__device__ __forceinline__ void sx_accumulate(
    const SxSpec& sp, const float* __restrict__ samples, const float* par,
    int nchains, int pstride, SxAcc<kW>* sh_hist, SxAcc<kW>* sh_norm,
    SxAcc<kW>* g_hist, int nrep, const int* choff = nullptr) {
  static_assert(!(kOff && kW), "B5 takes unweighted samples only");
  if constexpr (kWide)
    sx_accumulate_obs<SX_MAXFIELDS, kChains, kOff, kW>(
        sp, samples, par, nchains, pstride, sh_hist, sh_norm, g_hist, nrep,
        choff);
  else if (sp.nload == 1)
    sx_accumulate_obs<1, kChains, kOff, kW>(sp, samples, par, nchains,
                                            pstride, sh_hist, sh_norm,
                                            g_hist, nrep, choff);
  else
    sx_accumulate_obs<SX_MAXOBS, kChains, kOff, kW>(
        sp, samples, par, nchains, pstride, sh_hist, sh_norm, g_hist, nrep,
        choff);
}

// Add the block's shared replicas and in-domain counts of nchains
// chains to global memory.  kOff: chain c's histogram goes to g_hist +
// choff[c] and its in-domain counts right after it (g_norm unused).
// kChains with replicas: the in-domain counts are first summed from
// the bins (sx_accumulate counted none), in the same pass: a warp whose
// cells all belong to one (chain, segment) adds their warp sum, others
// add cell by cell.  Starts and ends on __syncthreads' side.
template <bool kChains, bool kOff = false, bool kW = false>
__device__ __forceinline__ void sx_flush(const SxSpec& sp, int nchains,
                                         const SxAcc<kW>* sh_hist,
                                         SxAcc<kW>* sh_norm, int nrep,
                                         SxAcc<kW>* g_hist,
                                         SxAcc<kW>* g_norm,
                                         const int* choff = nullptr) {
  using Acc = SxAcc<kW>;
  const int per = sp.ndyn * sp.total;  // one chain's histograms
  const int nh = nchains * per;
  const int lane = threadIdx.x & 31;
  if (nrep) {
    // Warp-uniform: every lane of a warp runs each pass.
    for (int base = threadIdx.x & ~31; base < nh; base += blockDim.x) {
      const int t = base + lane;
      Acc v = 0;
      if (t < nh) {
        for (int r = 0; r < nrep; ++r) v += sh_hist[r * nh + t];
        if constexpr (kOff) {
          const int c = t / per;
          if (v) atomicAdd(&g_hist[choff[c] + (t - c * per)], v);
        } else {
          if (v != Acc(0)) atomicAdd(&g_hist[t], v);
        }
      }
      if constexpr (kChains) {
        const int key = t < nh ? t / sp.total : -1;  // chain * ndyn + seg
        const int key0 = __shfl_sync(0xffffffffu, key, 0);
        if (__all_sync(0xffffffffu, key == key0)) {
          Acc s;
          if constexpr (kW) {
            s = sx_warp_sum(v);
          } else {
            s = __reduce_add_sync(0xffffffffu, v);
          }
          if (lane == 0 && s != Acc(0)) atomicAdd(&sh_norm[key0], s);
        } else if (v != Acc(0)) {
          atomicAdd(&sh_norm[key], v);
        }
      }
    }
    if constexpr (kChains) __syncthreads();
  }
  for (int t = threadIdx.x; t < nchains * sp.ndyn; t += blockDim.x) {
    if constexpr (kOff) {
      const int c = t / sp.ndyn;
      if (sh_norm[t])
        atomicAdd(&g_hist[choff[c] + per + (t - c * sp.ndyn)], sh_norm[t]);
    } else {
      if (sh_norm[t] != Acc(0)) atomicAdd(&g_norm[t], sh_norm[t]);
    }
  }
}

// Norms and per-signal weights ((rate * nexpected) * norm) / n_mc of
// nch chains at their proposals s_prop; entry t is signal t % nsig of
// chain t / nsig.  A dynamic signal's norm is its in-domain count (or
// weight sum, rounded to float32), norm_of(c)[slot] (chain c's counts
// in global memory, complete after a grid barrier); a static signal's
// is norm_init.
template <class NormOf>
__device__ __forceinline__ void sx_weights(const SxSpec& sp, int nch,
                                           const float* s_prop,
                                           NormOf norm_of, float* s_w,
                                           float* s_norm) {
  for (int t = threadIdx.x; t < nch * sp.nsig; t += blockDim.x) {
    const int c = t / sp.nsig;
    const int j = t - c * sp.nsig;
    const int slot = sp.sig_slot[j];
    const float norm =
        slot >= 0 ? (float)__ldcg(&norm_of(c)[slot]) : sp.norm_init[j];
    const float rate = s_prop[c * sp.npar + sp.source_id[j]];
    s_norm[t] = norm;
    s_w[t] = ((rate * sp.nexpected[j]) * norm) / sp.n_mc[j];
  }
}

// One thread's share of a chain's event log-sum against its histograms
// chist (ndyn, total; counts, or float64 weight sums rounded here to
// float32): events first, first + step, ...; LUT gather with the -1/-2
// sentinels (both give 0 here, as nll_pair's nan_to_num makes them),
// the mix in ascending signal order, log where positive; f64
// accumulation.
template <class Acc>
__device__ __forceinline__ double sx_event_sum(
    const SxSpec& sp, const Acc* chist,
    const float* __restrict__ hist_init, const int* __restrict__ rb,
    int nev, const float* cw, const float* cn, long long first,
    long long step) {
  double acc = 0.0;
  for (long long i = first; i < nev; i += step) {
    float mix = 0.0f;
    for (int j = 0; j < sp.nsig; ++j) {
      const int b = rb[(long long)j * nev + i];
      float val = 0.0f;
      if (b >= 0) {
        const int slot = sp.sig_slot[j];
        const float cnt = slot >= 0
                              ? (float)__ldcg(&chist[slot * sp.total + b])
                              : hist_init[j * sp.total + b];
        val = cnt / (cn[j] * sp.bin_volume);
        if (!isfinite(val)) val = 0.0f;
      }
      const float term = cw[j] * val;
      mix = (j == 0) ? term : mix + term;
    }
    if (mix > 0.0f) acc += (double)logf(mix);
  }
  return acc;
}

// The partial slots of each chain's event sum (sx_event_partials), in
// a grid of gridDim.x blocks: one chain sweeps its events over the
// whole grid (gridDim.x slots); each of nch lock-step chains over a
// contiguous range of its own blocks, as many as its nev events fill at
// SX_THREADS a block, at most gridDim.x / nch (at least one).
__device__ __forceinline__ int sx_event_slots(bool chains, int nch,
                                              int nev) {
  if (!chains) return (int)gridDim.x;
  const int fill = (nev + SX_THREADS - 1) / SX_THREADS;
  return max(1, min(fill, (int)gridDim.x / nch));
}

// The block's event sums of nch chains (chain c against hist_of(c) and
// the read bins rb_of(c): one dataset's for every chain, or each
// experiment's in the experiment-grouped forms) into fixed slots, so
// that a run repeats bit for bit.  One chain: every block sweeps a
// share of the events, reduced through a shared tree (s_red, SX_THREADS
// doubles; measured faster on an H100 than warp shuffles for one
// chain), into partials[blockIdx.x].  Lock-step chains: chain c's
// events go to its nslot = sx_event_slots(...) blocks c * nslot + j,
// block j sweeping events j * SX_THREADS + tid, then every nslot *
// SX_THREADS, reduced by warp shuffles and one thread over the warps'
// sums (s_red, SX_THREADS / 32 doubles) into partials[c * nslot + j];
// the chains' sweeps run side by side instead of one after another in
// the few blocks that hold events.  Starts on __syncthreads' side, and
// ends before a grid barrier: every thread must call it.
template <bool kChains, class HistOf, class RbOf>
__device__ __forceinline__ void sx_event_partials(
    const SxSpec& sp, int nch, HistOf hist_of,
    const float* __restrict__ hist_init, RbOf rb_of, int nev,
    const float* s_w, const float* s_norm, double* s_red,
    double* partials) {
  const int tid = threadIdx.x;
  if constexpr (kChains) {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nslot = sx_event_slots(true, nch, nev);
    for (int v = blockIdx.x; v < nch * nslot; v += gridDim.x) {
      const int c = v / nslot;
      const int j = v - c * nslot;
      double acc = sx_event_sum(
          sp, hist_of(c), hist_init, rb_of(c), nev, s_w + c * sp.nsig,
          s_norm + c * sp.nsig, (long long)j * SX_THREADS + tid,
          (long long)nslot * SX_THREADS);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) s_red[warp] = acc;
      __syncthreads();
      if (tid == 0) {
        double sum = 0.0;
        for (int w = 0; w < SX_THREADS / 32; ++w) sum += s_red[w];
        partials[v] = sum;
      }
      __syncthreads();
    }
  } else {
    double acc = sx_event_sum(
        sp, hist_of(0), hist_init, rb_of(0), nev, s_w, s_norm,
        (long long)blockIdx.x * blockDim.x + tid,
        (long long)gridDim.x * blockDim.x);
    s_red[tid] = acc;
    __syncthreads();
    for (int h = SX_THREADS / 2; h > 0; h >>= 1) {
      if (tid < h) s_red[tid] += s_red[tid + h];
      __syncthreads();
    }
    if (tid == 0) partials[blockIdx.x] = s_red[0];
  }
}

// A chain's NLL pair (hi, lo) at prop (npar,), after a grid barrier:
// the warp sums the chain's nslot partial slots cp (sx_event_slots) in
// a fixed order,
// and lane 0 finishes (the per-signal weights cw summed in f64, the
// Gaussian constraints, the negative-rate and non-finite barrier at
// f32(1e18)).  Every lane of the warp must call it; only lane 0's
// result is the NLL.
__device__ __forceinline__ void sx_finish(const SxSpec& sp, const double* cp,
                                          int nslot, const float* prop,
                                          const float* cw, float* hi_out,
                                          float* lo_out) {
  const int lane = threadIdx.x & 31;
  double v = 0.0;
  for (int b = lane; b < nslot; b += 32) v += __ldcg(&cp[b]);
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane != 0) return;
  const float ev_hi = (float)v;
  const float ev_lo = (float)(v - (double)ev_hi);
  double wsum = 0.0;
  for (int j = 0; j < sp.nsig; ++j) wsum += (double)cw[j];
  double con = 0.0;
  bool neg_rate = false;
  for (int k = 0; k < sp.npar; ++k) {
    if (sp.sigmas[k] > 0.0f) {
      const float z = (prop[k] - sp.means[k]) / sp.sigmas[k];
      con += (double)(z * z);
    }
    if (k < sp.nsources && prop[k] < 0.0f) neg_rate = true;
  }
  const double ev = (double)ev_hi + (double)ev_lo;
  const double total = -ev + wsum + 0.5 * con;
  float hi = (float)total;
  float lo = (float)(total - (double)hi);
  if (neg_rate || !isfinite(ev_hi)) {
    hi = 1e18f;
    lo = 0.0f;
  }
  *hi_out = hi;
  *lo_out = lo;
}
