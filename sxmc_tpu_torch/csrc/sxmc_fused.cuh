// The persistent kernels of sxmc_tpu_torch (Hopper, sm_90a): B3/B4
// (sx_fused_kernel) and B5 (sx_blocked_kernel), and their instantiation
// selectors.  Included by sxmc_kernels.cu, which builds the forms whose
// binning holds at most SX_MAXOBS fields and carries the C interface,
// and by sxmc_wide.cu, which builds the kWide forms: the two compile in
// parallel.  The design notes are in sxmc_kernels.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sxmc_phases.cuh"

namespace cg = cooperative_groups;

// Every kernel's dynamic shared memory: histogram replicas and norms,
// unsigned or float64 (hence the 8-byte alignment).
#define SX_DYN_SMEM(Acc, name)                         \
  extern __shared__ __align__(8) unsigned sx_smem[];   \
  Acc* name = reinterpret_cast<Acc*>(sx_smem)

// ------------------------------------------------------------- B3/B4

// Chain c's read bins: the one dataset's (nsig, nev) rows, or with kGrp
// those of experiment c / cpe in (nexp, nsig, nev).
template <bool kGrp>
__device__ __forceinline__ const int* sx_chain_rb(const SxSpec& sp,
                                                  const int* rb, int nev,
                                                  int cpe, int c) {
  if constexpr (kGrp) return rb + (long long)(c / cpe) * sp.nsig * nev;
  return rb;
}

// The cooperative grid never holds more than 4 blocks per SM
// (sx_fused_grid), so the kernel may use 64 registers a thread: with
// them ptxas spills nothing (at its default 32 the per-sample field
// arrays spilled, and a step took ~1 us longer on an H100).
//
// kTril: full-covariance proposals cur + L @ z with width holding each
// chain's lower-triangular L (nchains, npar, npar), read from global
// memory (32 chains x 16 parameters would not fit the static shared
// arrays).  The diagonal instantiations do not contain that code.
//
// kW: weighted MC samples (see sx_accumulate); scratch holds float64
// histograms and norms.
//
// kTemp: parallel tempering, each chain c a replica at inverse
// temperature beta[c]: the accept takes delta = beta[c] * ((cur_hi -
// hi) + (cur_lo - lo)) (pallas_step.py:782-786); beta > 0 keeps the sign,
// so the fast-accept branch is unchanged.  The 1/sqrt(beta) widening of
// the proposals is in the width rows the caller passes.
//
// kGrp: the experiment-grouped form of the sharded ensemble
// (pallas_step.py:741-752).  rb holds (nexp, nsig, nev) read bins and
// chain c sums the events of experiment c / cpe (its rows start at rb +
// (c / cpe) * nsig * nev); every chain still shares each sample read of
// the rebuild.  Experiments padded to a common nev carry sentinel read
// bins (-1 or -2) in their pad rows, which add exactly 0.  The grouped forms
// are lock-step forms (kChains) and never tempered.
//
// kWide: a layout whose systematics transform a sample field past the
// fourth (nload > SX_MAXOBS) takes the binning that holds every field
// (sx_accumulate); its forms are built apart (sxmc_wide.cu), so that
// the others keep their registers.
//
// Each flag is a template parameter, so that the forms without it
// compile to what they were before it existed.
template <bool kChains, bool kTril, bool kW, bool kTemp, bool kGrp,
          bool kWide>
__global__ void __launch_bounds__(SX_THREADS, 4)
sx_fused_kernel(const SxSpec sp, int nch, const float* __restrict__ samples,
                const float* __restrict__ hist_init,
                const int* __restrict__ rb, int nev, int cpe,
                const float* __restrict__ params0,
                const float* __restrict__ nll0,
                const float* __restrict__ width,
                const float* __restrict__ beta,
                const float* __restrict__ noise,
                const float* __restrict__ log_u, int nsteps, int debug,
                SxAcc<kW>* scratch, double* partials, float* samples_out,
                float* nlls_out, float* acc_out, int nrep) {
  using Acc = SxAcc<kW>;
  static_assert(!kGrp || (kChains && !kTemp), "grouped forms: chains only");
  if (!kChains) nch = 1;  // lets the compiler fold the chain loops away
  cg::grid_group grid = cg::this_grid();
  SX_DYN_SMEM(Acc, sh);
  __shared__ float s_cur[SX_MAXCP];
  __shared__ float s_prop[SX_MAXCP];
  __shared__ float s_w[SX_MAXCS];
  __shared__ float s_norm[SX_MAXCS];
  __shared__ float s_pair[2 * SX_MAXCHAINS];
  __shared__ int s_accept[SX_MAXCHAINS];
  __shared__ double s_red[kChains ? SX_THREADS / 32 : SX_THREADS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = SX_THREADS / 32;
  const int np = sp.npar;
  const int ncp = nch * np;
  const int nh = nch * sp.ndyn * sp.total;  // every chain's histograms
  const int buf = nh + nch * sp.ndyn;       // one buffer + its norms
  const int nslot = sx_event_slots(kChains, nch, nev);  // per chain
  Acc* sh_norm = sh + nrep * nh;
  const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const bool eval_only = nsteps == 0;
  const int nrun = eval_only ? 1 : nsteps;

  for (int t = tid; t < ncp; t += blockDim.x) s_cur[t] = params0[t];
  if (!eval_only)
    for (int t = tid; t < 2 * nch; t += blockDim.x) s_pair[t] = nll0[t];
  __syncthreads();

  for (int s = 0; s < nrun; ++s) {
    Acc* cur_hist = scratch + (s & 1) * buf;
    Acc* cur_norm = cur_hist + nh;
    Acc* next_hist = scratch + ((s + 1) & 1) * buf;

    // Propose.  Entry t is parameter t % np of chain t / np.
    for (int t = tid; t < ncp; t += blockDim.x) {
      const float c = s_cur[t];
      if (eval_only) {
        s_prop[t] = c;
      } else if constexpr (kTril) {
        // sum_{j <= k} L[k, j] * z[j] from 0.0f in ascending j, one
        // rounded add per term: the TPU kernel's order
        // (pallas_step.py:713-718).  Zero rows pin a parameter.
        const int k = t % np;
        const float* lrow = width + (long long)t * np;
        const float* z = noise + (long long)s * ncp + (t - k);
        float a = 0.0f;
        for (int j = 0; j <= k; ++j) a = a + lrow[j] * z[j];
        s_prop[t] = c + a;
      } else {
        // metropolis._make_step's op order, noise * max(w, 0); w <= 0
        // pins the parameter.
        const float w = width[t];
        const float nz = noise[(long long)s * ncp + t] * fmaxf(w, 0.0f);
        s_prop[t] = (w > 0.0f) ? c + nz : c;
      }
    }
    for (int t = tid; t < nrep * nh + nch * sp.ndyn; t += blockDim.x)
      sh[t] = Acc(0);
    // The buffer of step s - 1 is free again: clear it for step s + 1.
    for (long long t = gtid; t < buf; t += gstride) next_hist[t] = Acc(0);
    __syncthreads();

    // Rebuild every chain's dynamic histograms at its proposal.
    sx_accumulate<kChains, false, kW, kWide>(sp, samples, s_prop, nch, np,
                                             sh, sh_norm, cur_hist, nrep);
    __syncthreads();
    sx_flush<kChains, false, kW>(sp, nch, sh, sh_norm, nrep, cur_hist,
                                 cur_norm);
    grid.sync();

    sx_weights(sp, nch, s_prop,
               [&](int c) { return cur_norm + c * sp.ndyn; }, s_w, s_norm);
    __syncthreads();
    sx_event_partials<kChains>(
        sp, nch, [&](int c) { return cur_hist + c * sp.ndyn * sp.total; },
        hist_init,
        [&](int c) { return sx_chain_rb<kGrp>(sp, rb, nev, cpe, c); }, nev,
        s_w, s_norm, s_red, partials);
    grid.sync();

    // Every block: for each chain (warp w takes chains w, w + 8, ...)
    // the same fixed-order reduction, finish and decision.
    for (int c = warp; c < nch; c += nwarps) {
      float hi, lo;
      sx_finish(sp, partials + (long long)c * nslot, nslot, s_prop + c * np,
                s_w + c * sp.nsig, &hi, &lo);
      if (lane == 0) {
        if (eval_only) {
          if (blockIdx.x == 0) {
            nlls_out[2 * c] = hi;
            nlls_out[2 * c + 1] = lo;
          }
        } else {
          // df_diff's op order, then the log-space accept of the TPU
          // kernel: log(u) <= delta (pallas_step.py:782-792), delta
          // annealed by the replica's beta when tempered.
          float delta = (s_pair[2 * c] - hi) + (s_pair[2 * c + 1] - lo);
          if constexpr (kTemp) delta = beta[c] * delta;
          const bool a = debug || delta > 0.0f ||
                         log_u[(long long)s * nch + c] <= delta;
          s_accept[c] = a ? 1 : 0;
          if (a) {
            s_pair[2 * c] = hi;
            s_pair[2 * c + 1] = lo;
          }
          if (blockIdx.x == 0) {
            const long long o = (long long)s * nch + c;
            nlls_out[2 * o] = s_pair[2 * c];
            nlls_out[2 * o + 1] = s_pair[2 * c + 1];
            acc_out[o] = a ? 1.0f : 0.0f;
          }
        }
      }
    }
    __syncthreads();
    if (!eval_only) {
      for (int t = tid; t < ncp; t += blockDim.x) {
        if (s_accept[t / np]) s_cur[t] = s_prop[t];
        if (blockIdx.x == 0) samples_out[(long long)s * ncp + t] = s_cur[t];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- B5

// B5 -- blocked Metropolis-within-Gibbs (pallas_step.py::
// _make_blocked_segment_kernel).  A cycle is one systematic-block move
// (every parameter but the rates, where w > 0; a rebuild, two grid
// barriers) and then nsub - 1 rate-block moves (the rates only) that
// score the events against the CURRENT histogram and its in-domain
// counts: no rebuild, one grid barrier each.  The per-cycle output is
// the accepted fraction of the nsub decisions.
//
// Each chain owns two histogram buffers in scratch, (nchains, 2, ndyn *
// total + ndyn) unsigned ints; s_cb[c] says which one is current.  A
// systematic accept swaps the roles (every block takes the same
// decision, so each keeps the index in shared memory): nothing is
// copied.  The non-current buffer is cleared right after the systematic
// decision, while the rate moves run: its last reader (the rejected
// proposal's sweep, or the previous cycle's rate sweeps when the
// proposal was taken) finished before that decision's barrier, and the
// next rebuild comes after at least one more barrier (nsub >= 2).  A
// rate move has one barrier, so a block can write the next decision's
// event partials while a slower one still reduces this decision's: the
// partials are double-buffered by decision parity.  A prologue rebuilds
// every chain's current histogram at params0 (buffer 0), so a blocked
// phase is one launch.  kGrp: experiment-grouped, as sx_fused_kernel's
// (both event sweeps read chain c's experiment's rows); kWide as
// sx_fused_kernel's.
template <bool kChains, bool kGrp, bool kWide>
__global__ void __launch_bounds__(SX_THREADS, 4)
sx_blocked_kernel(const SxSpec sp, int nch,
                  const float* __restrict__ samples,
                  const float* __restrict__ hist_init,
                  const int* __restrict__ rb, int nev, int cpe,
                  const float* __restrict__ params0,
                  const float* __restrict__ nll0,
                  const float* __restrict__ width,
                  const float* __restrict__ noise,
                  const float* __restrict__ log_u, int ncycles, int nsub,
                  int debug, unsigned* scratch, double* partials,
                  float* samples_out, float* nlls_out, float* acc_out,
                  int nrep) {
  static_assert(!kGrp || kChains, "grouped forms: chains only");
  if (!kChains) nch = 1;
  cg::grid_group grid = cg::this_grid();
  SX_DYN_SMEM(unsigned, sh);
  __shared__ float s_cur[SX_MAXCP];
  __shared__ float s_prop[SX_MAXCP];
  __shared__ float s_w[SX_MAXCS];
  __shared__ float s_norm[SX_MAXCS];
  __shared__ float s_pair[2 * SX_MAXCHAINS];
  __shared__ int s_accept[SX_MAXCHAINS];
  __shared__ int s_accn[SX_MAXCHAINS];  // accepted decisions this cycle
  __shared__ int s_cb[SX_MAXCHAINS];    // each chain's current buffer
  __shared__ int s_off[SX_MAXCHAINS];   // each chain's rebuild target
  __shared__ double s_red[kChains ? SX_THREADS / 32 : SX_THREADS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = SX_THREADS / 32;
  const int np = sp.npar;
  const int ncp = nch * np;
  const int nh = nch * sp.ndyn * sp.total;
  const int per = sp.ndyn * sp.total + sp.ndyn;  // one buffer of a chain
  const int nslot = sx_event_slots(kChains, nch, nev);  // per chain
  unsigned* sh_norm = sh + nrep * nh;
  const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  auto buffer = [&](int c, int b) { return scratch + (2 * c + b) * per; };
  auto rb_of = [&](int c) { return sx_chain_rb<kGrp>(sp, rb, nev, cpe, c); };

  for (int t = tid; t < ncp; t += blockDim.x) s_cur[t] = params0[t];
  for (int t = tid; t < 2 * nch; t += blockDim.x) s_pair[t] = nll0[t];
  for (int c = tid; c < nch; c += blockDim.x) {
    s_cb[c] = 0;
    s_off[c] = 2 * c * per;
  }
  for (int t = tid; t < nrep * nh + nch * sp.ndyn; t += blockDim.x)
    sh[t] = 0u;
  __syncthreads();
  // Prologue: the current histograms at params0 into buffer 0 (scratch
  // arrives zeroed).  The first reads of them come after the first
  // cycle's two barriers.
  sx_accumulate<kChains, true, false, kWide>(sp, samples, s_cur, nch, np,
                                             sh, sh_norm, scratch, nrep,
                                             s_off);
  __syncthreads();
  sx_flush<kChains, true>(sp, nch, sh, sh_norm, nrep, scratch, nullptr,
                          s_off);
  __syncthreads();

  for (int s = 0; s < ncycles; ++s) {
    for (int sub = 0; sub < nsub; ++sub) {
      const long long row = (long long)s * nsub + sub;  // decision index
      double* part = partials + (row & 1) * nch * gridDim.x;
      const bool syst = sub == 0;
      // Propose the block (pallas_step.py:1115-1129): rates (k <
      // nsources) in a rate move, everything else in a systematic
      // move, noise * max(w, 0) where w > 0.
      for (int t = tid; t < ncp; t += blockDim.x) {
        const int k = t % np;
        const float c = s_cur[t];
        const float w = width[t];
        const float nz = noise[row * ncp + t] * fmaxf(w, 0.0f);
        s_prop[t] = (w > 0.0f && (k < sp.nsources) != syst) ? c + nz : c;
      }
      if (syst) {
        for (int c = tid; c < nch; c += blockDim.x)
          s_off[c] = (2 * c + 1 - s_cb[c]) * per;
        for (int t = tid; t < nrep * nh + nch * sp.ndyn; t += blockDim.x)
          sh[t] = 0u;
        __syncthreads();
        // Rebuild each chain's systematic proposal into its free buffer.
        sx_accumulate<kChains, true, false, kWide>(
            sp, samples, s_prop, nch, np, sh, sh_norm, scratch, nrep, s_off);
        __syncthreads();
        sx_flush<kChains, true>(sp, nch, sh, sh_norm, nrep, scratch, nullptr,
                                s_off);
        grid.sync();
        sx_weights(sp, nch, s_prop,
                   [&](int c) { return scratch + s_off[c] + per - sp.ndyn; },
                   s_w, s_norm);
        __syncthreads();
        sx_event_partials<kChains>(
            sp, nch, [&](int c) { return scratch + s_off[c]; }, hist_init,
            rb_of, nev, s_w, s_norm, s_red, part);
      } else {
        __syncthreads();
        sx_weights(sp, nch, s_prop,
                   [&](int c) { return buffer(c, s_cb[c]) + per - sp.ndyn; },
                   s_w, s_norm);
        __syncthreads();
        sx_event_partials<kChains>(
            sp, nch, [&](int c) { return buffer(c, s_cb[c]); }, hist_init,
            rb_of, nev, s_w, s_norm, s_red, part);
      }
      grid.sync();

      // Every block takes every chain's decision (warp w takes chains
      // w, w + 8, ...), as B4 does.
      for (int c = warp; c < nch; c += nwarps) {
        float hi, lo;
        sx_finish(sp, part + (long long)c * nslot, nslot, s_prop + c * np,
                  s_w + c * sp.nsig, &hi, &lo);
        if (lane == 0) {
          const float delta =
              (s_pair[2 * c] - hi) + (s_pair[2 * c + 1] - lo);
          const bool a = debug || delta > 0.0f ||
                         log_u[row * nch + c] <= delta;
          s_accept[c] = a ? 1 : 0;
          s_accn[c] = (syst ? 0 : s_accn[c]) + (a ? 1 : 0);
          if (a) {
            s_pair[2 * c] = hi;
            s_pair[2 * c + 1] = lo;
            if (syst) s_cb[c] = 1 - s_cb[c];
          }
          if (sub == nsub - 1 && blockIdx.x == 0) {
            const long long o = (long long)s * nch + c;
            nlls_out[2 * o] = s_pair[2 * c];
            nlls_out[2 * o + 1] = s_pair[2 * c + 1];
            acc_out[o] = (float)s_accn[c] / (float)nsub;
          }
        }
      }
      __syncthreads();
      for (int t = tid; t < ncp; t += blockDim.x) {
        if (s_accept[t / np]) s_cur[t] = s_prop[t];
        if (sub == nsub - 1 && blockIdx.x == 0)
          samples_out[(long long)s * ncp + t] = s_cur[t];
      }
      if (syst) {
        // Clear every chain's non-current buffer for the next rebuild.
        for (int c = 0; c < nch; ++c) {
          unsigned* b = buffer(c, 1 - s_cb[c]);
          for (long long t = gtid; t < per; t += gstride) b[t] = 0u;
        }
      }
      __syncthreads();
    }
  }
}

// Each kernel is built once per form: one chain (kChains = false) or
// lock-step chains, unweighted or weighted, for B4 diagonal, tril or
// tempered (diagonal) proposals, and experiment-grouped (lock-step, not
// tempered) for B4 and B5; each once with the binnings of up to four
// fields (sxmc_kernels.cu) and once with the binning of any (kWide,
// sxmc_wide.cu).
//
// B3/B4 forms (bits of form): tril proposals, weighted samples, tempered
// replicas, experiment-grouped chains.  Tempered proposals are diagonal
// and never grouped.
#define SX_TRIL 1
#define SX_WEIGHTED 2
#define SX_TEMPERED 4
#define SX_GROUPED 8

template <bool kChains, bool kW, bool kWide>
static const void* sx_fused_fn_w(int form) {
  const bool tril = (form & SX_TRIL) != 0;
  if (form & SX_GROUPED) {
    if (form & SX_TEMPERED) return nullptr;
    return tril
        ? (const void*)sx_fused_kernel<true, true, kW, false, true, kWide>
        : (const void*)sx_fused_kernel<true, false, kW, false, true, kWide>;
  }
  if (form & SX_TEMPERED)
    return tril ? nullptr
                : (const void*)
                      sx_fused_kernel<kChains, false, kW, true, false, kWide>;
  return tril
      ? (const void*)sx_fused_kernel<kChains, true, kW, false, false, kWide>
      : (const void*)sx_fused_kernel<kChains, false, kW, false, false, kWide>;
}

template <bool kWide>
static const void* sx_fused_fn_t(int nchains, int form) {
  const bool w = (form & SX_WEIGHTED) != 0;
  if (nchains == 1 && !(form & SX_GROUPED))
    return w ? sx_fused_fn_w<false, true, kWide>(form)
             : sx_fused_fn_w<false, false, kWide>(form);
  return w ? sx_fused_fn_w<true, true, kWide>(form)
           : sx_fused_fn_w<true, false, kWide>(form);
}

template <bool kWide>
static const void* sx_blocked_fn_t(int nchains, bool grouped) {
  if (grouped) return (const void*)sx_blocked_kernel<true, true, kWide>;
  return nchains == 1 ? (const void*)sx_blocked_kernel<false, false, kWide>
                      : (const void*)sx_blocked_kernel<true, false, kWide>;
}

// The kWide forms (sxmc_wide.cu).
const void* sx_fused_fn_wide(int nchains, int form);
const void* sx_blocked_fn_wide(int nchains, bool grouped);
