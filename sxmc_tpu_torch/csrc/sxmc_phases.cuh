// Shared device code of the sxmc_tpu_torch kernels (Hopper, sm_90a).
//
// The phase functions below are used by the segmented histogram (kernel
// B1, single and batched, unweighted and weighted), the fused NLL /
// whole-segment kernel (B3/B4, every form) and the blocked whole-segment
// kernel (B5), the
// way sxmc_tpu/ops/pallas_step.py::_phase_bodies shares its bodies
// between pallas_fused_step, pallas_fused_segment and
// pallas_fused_segment_blocked: one copy of the systematics and bin-id
// math, the event sweep and the NLL finish, so a proposal is binned and
// scored identically by every kernel.
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

// Bin the fields of one sample (of dynamic segment seg) after the masked
// systematics at parameters par: the flat bin id, or -1 when it is out
// of domain.  The systematics transform cols in place.
__device__ __forceinline__ int sx_bin_fields(const SxSpec& sp, float* cols,
                                             int seg, const float* par) {
  for (int k = 0; k < sp.nsyst; ++k) {
    if (!((sp.syst_mask[k] >> seg) & 1u)) continue;
    const int o = sp.syst_obs[k];
    const float x = cols[o];
    float p = 0.0f;
    float xi = 1.0f;
    for (int q = 0; q < sp.syst_npow[k]; ++q) {
      if (q > 0) xi = xi * x;
      p = p + par[sp.syst_par[k * SX_MAXPOW + q]] * xi;
    }
    float nw;
    switch (sp.syst_type[k]) {
      case SX_SHIFT: nw = x + p; break;
      case SX_SCALE: nw = x * (1.0f + p); break;
      case SX_CTSCALE: nw = 1.0f + (x - 1.0f) * (1.0f + p); break;
      default: nw = x + p * (x - cols[sp.syst_extra[k]]); break;
    }
    cols[o] = nw;
  }
  int id = 0;
  for (int a = 0; a < sp.nobs; ++a) {
    const float x = cols[a];
    if (!(x >= sp.lower[a] && x < sp.upper[a])) return -1;
    int ax = (int)floorf((x - sp.lower[a]) * sp.scale[a]);
    ax = min(max(ax, 0), sp.nbins[a] - 1);
    id += ax * sp.strides[a];
  }
  return id;
}

// Load sample i's fields (field-major: field f of sample i is
// samples[f * n + i]).
__device__ __forceinline__ void sx_load(const SxSpec& sp,
                                        const float* __restrict__ samples,
                                        long long n, long long i,
                                        float* cols) {
  for (int f = 0; f < sp.nfields; ++f) cols[f] = samples[f * n + i];
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
// One chain: each thread bins its samples in place and counts its
// in-domain ones, one warp sum per segment.  Lock-step chains: each
// sample is loaded once and binned for every chain (a copy of the
// loaded fields per chain but the last, which transforms them in
// place); the loop is warp-uniform (lanes past a segment's end idle)
// so that one ballot per chain and sample row counts the in-domain
// samples (weighted: a warp sum of their weights, where the ballot has
// any).  The kernels are instantiated once per form (kChains, kW), so
// the single chain's registers and spills are not the chains' loop's.
//
// kOff (the blocked kernel B5, unweighted): chain c's global histogram
// starts at g_hist + choff[c] instead of g_hist + c * ndyn * total, so
// that each chain can rebuild into whichever of its two buffers is not
// current.
template <bool kChains, bool kOff = false, bool kW = false>
__device__ __forceinline__ void sx_accumulate(
    const SxSpec& sp, const float* __restrict__ samples, const float* par,
    int nchains, int pstride, SxAcc<kW>* sh_hist, SxAcc<kW>* sh_norm,
    SxAcc<kW>* g_hist, int nrep, const int* choff = nullptr) {
  static_assert(!(kOff && kW), "B5 takes unweighted samples only");
  using Acc = SxAcc<kW>;
  const long long n = sp.seg_off[sp.ndyn];
  const float* __restrict__ wrow = samples + (long long)sp.nfields * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
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
        float cols[SX_MAXFIELDS];
        sx_load(sp, samples, n, i, cols);
        const int id = sx_bin_fields(sp, cols, seg, par);
        if (id >= 0) {
          if constexpr (kW) {
            const double w = (double)wrow[i];
            cnt += w;
            atomicAdd(&row[id], w);
          } else {
            ++cnt;
            atomicAdd(&row[id], 1u);
          }
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
        float in[SX_MAXFIELDS];
        if (live) sx_load(sp, samples, n, i, in);
        float w = 0.0f;
        if constexpr (kW) {
          if (live) w = wrow[i];
        }
        for (int c = 0; c < nchains; ++c) {
          int id = -1;
          if (live) {
            if (c + 1 < nchains) {
              float cols[SX_MAXFIELDS];
              for (int f = 0; f < sp.nfields; ++f) cols[f] = in[f];
              id = sx_bin_fields(sp, cols, seg, par + c * pstride);
            } else {
              id = sx_bin_fields(sp, in, seg, par + c * pstride);
            }
          }
          Acc one;
          if constexpr (kW) {
            one = (double)w;
          } else {
            one = 1u;
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
          const unsigned hit = __ballot_sync(0xffffffffu, id >= 0);
          if constexpr (kW) {
            if (hit) {  // warp-uniform
              const double v = sx_warp_sum(id >= 0 ? (double)w : 0.0);
              if (lane == 0) atomicAdd(&sh_norm[c * sp.ndyn + seg], v);
            }
          } else {
            if (lane == 0 && hit)
              atomicAdd(&sh_norm[c * sp.ndyn + seg], (unsigned)__popc(hit));
          }
        }
      }
    }
  }
}

// Add the block's shared replicas and in-domain counts of nchains
// chains to global memory.  kOff: chain c's histogram goes to g_hist +
// choff[c] and its in-domain counts right after it (g_norm unused).
template <bool kOff = false, bool kW = false>
__device__ __forceinline__ void sx_flush(const SxSpec& sp, int nchains,
                                         const SxAcc<kW>* sh_hist,
                                         const SxAcc<kW>* sh_norm, int nrep,
                                         SxAcc<kW>* g_hist,
                                         SxAcc<kW>* g_norm,
                                         const int* choff = nullptr) {
  using Acc = SxAcc<kW>;
  const int per = sp.ndyn * sp.total;  // one chain's histograms
  const int nh = nchains * per;
  if (nrep) {
    for (int t = threadIdx.x; t < nh; t += blockDim.x) {
      Acc v = 0;
      for (int r = 0; r < nrep; ++r) v += sh_hist[r * nh + t];
      if constexpr (kOff) {
        const int c = t / per;
        if (v) atomicAdd(&g_hist[choff[c] + (t - c * per)], v);
      } else {
        if (v != Acc(0)) atomicAdd(&g_hist[t], v);
      }
    }
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
// float32): LUT gather with the -1/-2 sentinels (both give 0 here, as
// nll_pair's nan_to_num makes them), the mix in ascending signal order,
// log where positive; f64 accumulation.
template <class Acc>
__device__ __forceinline__ double sx_event_sum(
    const SxSpec& sp, const Acc* chist,
    const float* __restrict__ hist_init, const int* __restrict__ rb,
    int nev, const float* cw, const float* cn) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  double acc = 0.0;
  for (long long i = gtid; i < nev; i += gstride) {
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

// The block's event sums of nch chains (chain c against hist_of(c) and
// the read bins rb_of(c): one dataset's for every chain, or each
// experiment's in the experiment-grouped forms) into the fixed slots
// partials[c * gridDim.x + blockIdx.x].  One chain
// reduces through a shared tree (s_red, SX_THREADS doubles; measured
// faster on an H100 than warp shuffles for one chain), lock-step chains
// through warp shuffles into s_warp (nch * SX_THREADS / 32 doubles).
// Starts and ends on __syncthreads' side: every thread must call it.
template <bool kChains, class HistOf, class RbOf>
__device__ __forceinline__ void sx_event_partials(
    const SxSpec& sp, int nch, HistOf hist_of,
    const float* __restrict__ hist_init, RbOf rb_of, int nev,
    const float* s_w, const float* s_norm, double* s_warp, double* s_red,
    double* partials) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = SX_THREADS / 32;
  for (int c = 0; c < nch; ++c) {
    double acc = sx_event_sum(sp, hist_of(c), hist_init, rb_of(c), nev,
                              s_w + c * sp.nsig, s_norm + c * sp.nsig);
    if constexpr (kChains) {
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) s_warp[c * nwarps + warp] = acc;
    } else {
      s_red[tid] = acc;
    }
  }
  __syncthreads();
  if constexpr (kChains) {
    for (int c = tid; c < nch; c += blockDim.x) {
      double v = 0.0;
      for (int w = 0; w < nwarps; ++w) v += s_warp[c * nwarps + w];
      partials[(long long)c * gridDim.x + blockIdx.x] = v;
    }
  } else {
    for (int h = SX_THREADS / 2; h > 0; h >>= 1) {
      if (tid < h) s_red[tid] += s_red[tid + h];
      __syncthreads();
    }
    if (tid == 0) partials[blockIdx.x] = s_red[0];
  }
}

// A chain's NLL pair (hi, lo) at prop (npar,), after a grid barrier:
// the warp sums the chain's gridDim.x partial slots cp in a fixed order,
// and lane 0 finishes (the per-signal weights cw summed in f64, the
// Gaussian constraints, the negative-rate and non-finite barrier at
// f32(1e18)).  Every lane of the warp must call it; only lane 0's
// result is the NLL.
__device__ __forceinline__ void sx_finish(const SxSpec& sp, const double* cp,
                                          const float* prop, const float* cw,
                                          float* hi_out, float* lo_out) {
  const int lane = threadIdx.x & 31;
  double v = 0.0;
  for (int b = lane; b < (int)gridDim.x; b += 32) v += __ldcg(&cp[b]);
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
