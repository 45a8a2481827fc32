// Shared device code of the sxmc_tpu_torch kernels (Hopper, sm_90a).
//
// The phase functions below are used by both the segmented histogram
// (kernel B1, single and batched) and the fused NLL / whole-segment
// kernel (B3/B4, single and batched), the
// way sxmc_tpu/ops/pallas_step.py::_phase_bodies shares its bodies
// between pallas_fused_step and pallas_fused_segment: one copy of the
// systematics and bin-id math, so a proposal is binned identically by
// every kernel.
//
// Arithmetic contract: every float operation is the JAX package's, in
// its order, in float32, and the library is built with -fmad=false so
// that nvcc contracts no a*b+c into an FMA.  floor((x - lo) * scale)
// is rounding-sensitive; an FMA would move samples that sit on a bin
// edge into the neighbouring bin.

#pragma once

#include <cstdint>

#define SX_MAXOBS 4
#define SX_MAXFIELDS 8
#define SX_MAXSEG 32
#define SX_MAXSIG 32
#define SX_MAXSYST 8
#define SX_MAXPOW 4
#define SX_MAXPAR 64
#define SX_MAXCHAINS 32  // lock-step chains of one launch
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
//
// One chain: each thread bins its samples in place and counts its
// in-domain ones, one warp sum per segment.  Lock-step chains: each
// sample is loaded once and binned for every chain (a copy of the
// loaded fields per chain but the last, which transforms them in
// place); the loop is warp-uniform (lanes past a segment's end idle)
// so that one ballot per chain and sample row counts the in-domain
// samples.  The kernels are instantiated once per form (kChains), so
// the single chain's registers and spills are not the chains' loop's.
template <bool kChains>
__device__ __forceinline__ void sx_accumulate(
    const SxSpec& sp, const float* __restrict__ samples, const float* par,
    int nchains, int pstride, unsigned* sh_hist, unsigned* sh_norm,
    unsigned* g_hist, int nrep) {
  const long long n = sp.seg_off[sp.ndyn];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned* mine =
      nrep ? sh_hist + (warp % nrep) * nchains * sp.ndyn * sp.total : g_hist;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int seg = 0; seg < sp.ndyn; ++seg) {
    const long long end = sp.seg_off[seg + 1];
    if constexpr (!kChains) {
      unsigned cnt = 0;
      unsigned* row = mine + seg * sp.total;
      for (long long i = sp.seg_off[seg] +
                         (long long)blockIdx.x * blockDim.x + threadIdx.x;
           i < end; i += stride) {
        float cols[SX_MAXFIELDS];
        sx_load(sp, samples, n, i, cols);
        const int id = sx_bin_fields(sp, cols, seg, par);
        if (id >= 0) {
          ++cnt;
          atomicAdd(&row[id], 1u);
        }
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0 && cnt) atomicAdd(&sh_norm[seg], cnt);
    } else {
      const long long first =
          (long long)blockIdx.x * blockDim.x + (warp << 5);
      for (long long base = sp.seg_off[seg] + first; base < end;
           base += stride) {
        const long long i = base + lane;
        const bool live = i < end;
        float in[SX_MAXFIELDS];
        if (live) sx_load(sp, samples, n, i, in);
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
          if (id >= 0)
            atomicAdd(&mine[(c * sp.ndyn + seg) * sp.total + id], 1u);
          const unsigned hit = __ballot_sync(0xffffffffu, id >= 0);
          if (lane == 0 && hit)
            atomicAdd(&sh_norm[c * sp.ndyn + seg], (unsigned)__popc(hit));
        }
      }
    }
  }
}

// Add the block's shared replicas and in-domain counts of nchains
// chains to global memory.
__device__ __forceinline__ void sx_flush(const SxSpec& sp, int nchains,
                                         const unsigned* sh_hist,
                                         const unsigned* sh_norm, int nrep,
                                         unsigned* g_hist, unsigned* g_norm) {
  const int nh = nchains * sp.ndyn * sp.total;
  if (nrep) {
    for (int t = threadIdx.x; t < nh; t += blockDim.x) {
      unsigned v = 0;
      for (int r = 0; r < nrep; ++r) v += sh_hist[r * nh + t];
      if (v) atomicAdd(&g_hist[t], v);
    }
  }
  for (int t = threadIdx.x; t < nchains * sp.ndyn; t += blockDim.x)
    if (sh_norm[t]) atomicAdd(&g_norm[t], sh_norm[t]);
}
