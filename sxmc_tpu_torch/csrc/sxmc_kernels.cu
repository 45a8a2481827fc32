// Hand-written Hopper (sm_90a) kernels of sxmc_tpu_torch, with a plain C
// interface loaded through ctypes (sxmc_tpu_torch/ops/kernels.py).
//
// B1  sx_histogram     replaces sxmc_tpu/ops/pallas_hist.py::
//                      pallas_histogram_segmented, single-theta form
//                      (nchains == 1) and batched theta (nchains, npar),
//                      unweighted and weighted; with one segment it also
//                      serves pallas_histogram (B1a).
// B2  sx_eval_lut      replaces sxmc_tpu/ops/pallas_hist.py::
//                      pallas_eval_lut.
// B3  sx_fused (nsteps == 0)
//                      replaces sxmc_tpu/ops/pallas_step.py::
//                      pallas_fused_step, single and batched chains,
//                      unweighted and weighted.
// B4  sx_fused (nsteps > 0)
//                      replaces sxmc_tpu/ops/pallas_step.py::
//                      pallas_fused_segment, single-chain and batched
//                      (lock-step chains) forms, diagonal and tril
//                      (full-covariance) proposals, tempered (a per-chain
//                      inverse temperature in the accept), each
//                      unweighted and weighted; experiment-grouped
//                      (cpe > 0: every experiment's chains in one
//                      launch, each reading its experiment's read bins),
//                      diagonal and tril, unweighted and weighted.
// B5  sx_blocked       replaces sxmc_tpu/ops/pallas_step.py::
//                      pallas_fused_segment_blocked, single-chain,
//                      batched and experiment-grouped forms.
//
// B1 -- what bounds it.  Per sample it reads the fields the binning
// uses (8 bytes on the reference example: the energy and, for the
// resolution systematic, the true energy), does a few float ops and one
// atomic increment per chain: a memory-bound pass with one chain,
// except that at few bins (the example has 10) every warp hits the same
// few counters; with chains the binning work grows nchains-fold over one
// read, and the binning's instructions bound it (measured on an H100).
// Design: one privatised unsigned histogram per warp group in shared
// memory (up to 8 replicas per block, chosen to fit 36 KB), flushed with
// one global atomicAdd per nonzero cell; measured on an H100, the
// rebuild then costs about the same at 10 bins as at 1000.  Batched,
// every replica holds all chains' histograms; when they do not fit (8
// chains x 2 signals x 1000 bins is 64 KB) the counts go to global
// memory per chain.  The binning keeps a sample in registers and reads
// the spec's entries as constant operands (sx_bin_row).  The TPU's
// two-level one-hot matmul, trash cell and chunk padding exist only
// because the TPU has no atomics; they are not carried over.  Segments
// are addressed by offsets, not padding.
//
// B2 -- what bounds it.  One gather per output: read a read bin, read a
// count (the table is small and stays in L1/L2), divide, write: memory-
// bound on the read bins and the output, 8 bytes per value.  Design: a
// 2-D grid (events x table rows), 4 events per thread with their read
// bins loaded together, no padding.  The TPU's one-hot matmul exists
// only because XLA's gather is slow on a TPU; it is not carried over.
//
// B3/B4 -- what bounds it.  One Metropolis step is: propose, rebuild
// the dynamic histograms (the whole MC set, ~12 MB at 1M samples,
// which stays in the 50 MB L2 from step to step), then one pass over
// the events.  At the reference example's 1500 events the event pass
// is tiny and a step is bounded by the rebuild and by the two grid-wide
// barriers it needs (the histogram must be complete before any event
// is evaluated; every block's event partial must be in before the
// accept).  The TPU kernel carried the chain state across an in-order
// sequential grid; a GPU grid runs in no order, so this is one
// persistent cooperative kernel that loops over the steps itself:
//   propose  (every block, redundantly, from the same shared state)
//   rebuild  (all blocks; histogram into one of two global buffers,
//             the other one zeroed for the next step)     -- grid.sync
//   norms, per-event gather + mix + log, f64 per-block partial into a
//             fixed slot per chain                         -- grid.sync
//   finish + accept (every block reduces each chain's slots in the same
//             fixed order and takes the same decision; block 0 writes
//             the history)
// Taking the decision in every block saves the third barrier a
// broadcast from block 0 would need.  Sums are float64 (the H100 has
// native f64; the TPU needed compensated f32 pairs), reduced in a fixed
// order, so the result is the same from run to run.  Lock-step chains
// (nchains > 1) share each step's sample reads and both barriers: each
// sample is loaded once and binned for every chain, each chain has its
// own double-buffered histograms, its events are swept by its own range
// of blocks (the chains' sweeps side by side, one partial slot per block
// of the range), and every block reduces every chain's few slots and
// takes every chain's decision.
//
// Weighted forms (a float32 weight per MC row): bins and norms sum the
// weights in float64 (shared and global atomics, native on sm_90) and
// are rounded once to float32 where they are read, so the order the
// atomics land in moves a sum by ~1e-16 relative and the float32 value
// equals the plain version's (index_add_ in float64, then rounded) but
// on a rounding tie.  The TPU accumulated float32 one-hot products and
// carried the norms as compensated float32 pairs; neither is needed on
// a card with native float64 atomics.  The f64 replicas take twice the
// shared memory of the unsigned counts; when they do not fit the budget
// the atomics go to global memory, as for large unweighted histograms.
//
// B5 -- what bounds it.  A blocked cycle is one B4 step for the
// systematic block and then M rate moves, each a pass over the events
// against the carried histogram: at the example's 1500 events a rate
// move is bounded by its one grid barrier and the partial reduction,
// not by the sweep.  Same persistent design as B4; see sx_blocked_kernel
// for how the histogram buffers and partials are shared safely.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "sxmc_phases.cuh"

namespace cg = cooperative_groups;

// Dynamic shared memory for histogram replicas; with sx_fused_kernel's
// and sx_blocked_kernel's up to ~8.8 KB of static arrays (sx_hist_kernel's
// 8 KB) a block stays under the 48 KB a launch gets without an opt-in.
static const int kSmemBudget = 36 * 1024;

// Bytes of one histogram cell or norm: an unsigned count, or a float64
// weight sum.
static int sx_cell_bytes(bool weighted) { return weighted ? 8 : 4; }

// Shared-memory histogram replicas (each holding all nchains chains)
// that fit the budget (0: use global).
static int sx_replicas(const SxSpec& sp, int nchains, bool weighted) {
  const long long eb = sx_cell_bytes(weighted);
  const long long per = eb * nchains * sp.ndyn * sp.total;
  const long long norm = eb * nchains * sp.ndyn;
  if (per == 0 || per + norm > kSmemBudget) return 0;
  long long r = (kSmemBudget - norm) / per;
  const int warps = SX_THREADS / 32;
  return (int)(r < warps ? r : warps);
}

static int sx_smem_bytes(const SxSpec& sp, int nchains, int nrep,
                         bool weighted) {
  return sx_cell_bytes(weighted) * nchains *
         (nrep * sp.ndyn * sp.total + sp.ndyn);
}

static cudaError_t sx_num_sms(int* nsm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
}

// ---------------------------------------------------------------- B1

// Every kernel's dynamic shared memory: histogram replicas and norms,
// unsigned or float64 (hence the 8-byte alignment).
#define SX_DYN_SMEM(Acc, name)                         \
  extern __shared__ __align__(8) unsigned sx_smem[];   \
  Acc* name = reinterpret_cast<Acc*>(sx_smem)

// The launch holds at most 4 blocks per SM (sx_histogram), so a thread
// may use 64 registers, as in the fused kernels.  The parameters are
// copied to shared memory, where the binning reads them.
template <bool kChains, bool kW>
__global__ void __launch_bounds__(SX_THREADS, 4)
sx_hist_kernel(const SxSpec sp, const float* __restrict__ samples,
               const float* __restrict__ par, int nchains, int pstride,
               SxAcc<kW>* g_hist, SxAcc<kW>* g_norm, int nrep) {
  using Acc = SxAcc<kW>;
  SX_DYN_SMEM(Acc, sh);
  __shared__ float s_par[SX_MAXCHAINS * SX_MAXPAR];
  const int nh = nchains * sp.ndyn * sp.total;
  Acc* sh_norm = sh + nrep * nh;
  for (int t = threadIdx.x; t < nrep * nh + nchains * sp.ndyn;
       t += blockDim.x)
    sh[t] = Acc(0);
  for (int t = threadIdx.x; t < nchains * pstride; t += blockDim.x)
    s_par[t] = par[t];
  __syncthreads();
  sx_accumulate<kChains, false, kW>(sp, samples, s_par, nchains, pstride, sh,
                                    sh_norm, g_hist, nrep);
  __syncthreads();
  sx_flush<kChains, false, kW>(sp, nchains, sh, sh_norm, nrep, g_hist,
                               g_norm);
}

// Counts or float64 sums -> float32 (round to nearest, once).
template <class Acc>
__global__ void sx_to_float(const Acc* __restrict__ in,
                            float* __restrict__ out, int n) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x)
    out[t] = (float)in[t];
}

// ---------------------------------------------------------------- B2

// out[s, i] = counts[s, rb] / (norms[s] * bin_volume) with rb the read
// bin of output row s (rb row s % rb_rows): -1 -> NaN (out of domain),
// -2 -> 0 (dataset mismatch).  A 2-D grid: x over the events, y over
// the table rows, so no thread divides an index.  Each thread takes
// kLutPer events a block apart and loads all their read bins before it
// uses one: one 4-byte load in flight per thread leaves the memory
// system half idle.  The float32 division is IEEE (nvcc's default
// -prec-div=true), as torch's, so both give the same bits.
static const int kLutPer = 4;

__global__ void sx_eval_lut_kernel(const float* __restrict__ counts,
                                   const float* __restrict__ norms,
                                   const int* __restrict__ rb, int nseg,
                                   int rb_rows, int total, long long nev,
                                   float bin_volume, float* __restrict__ out) {
  const long long i0 =
      (long long)blockIdx.x * blockDim.x * kLutPer + threadIdx.x;
  for (int s = blockIdx.y; s < nseg; s += gridDim.y) {
    const float denom = norms[s] * bin_volume;
    const int* row = rb + (long long)(s % rb_rows) * nev;
    const float* cnt = counts + (long long)s * total;
    int b[kLutPer];
#pragma unroll
    for (int k = 0; k < kLutPer; ++k) {
      const long long i = i0 + (long long)k * blockDim.x;
      b[k] = i < nev ? row[i] : -2;
    }
#pragma unroll
    for (int k = 0; k < kLutPer; ++k) {
      const long long i = i0 + (long long)k * blockDim.x;
      float v;
      if (b[k] == -1) {
        v = __int_as_float(0x7fc00000);  // the canonical quiet NaN, as torch's
      } else if (b[k] == -2) {
        v = 0.0f;
      } else {
        v = cnt[min(max(b[k], 0), total - 1)] / denom;
      }
      if (i < nev) out[(long long)s * nev + i] = v;
    }
  }
}

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
// Each flag is a template parameter, so that the forms without it
// compile to what they were before it existed.
template <bool kChains, bool kTril, bool kW, bool kTemp, bool kGrp>
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
    sx_accumulate<kChains, false, kW>(sp, samples, s_prop, nch, np, sh,
                                      sh_norm, cur_hist, nrep);
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
// (both event sweeps read chain c's experiment's rows).
template <bool kChains, bool kGrp>
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
  sx_accumulate<kChains, true>(sp, samples, s_cur, nch, np, sh, sh_norm,
                               scratch, nrep, s_off);
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
        sx_accumulate<kChains, true>(sp, samples, s_prop, nch, np, sh,
                                     sh_norm, scratch, nrep, s_off);
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
// tempered) for B4 and B5.
static const void* sx_hist_fn(int nchains, bool w) {
  if (w)
    return nchains == 1 ? (const void*)sx_hist_kernel<false, true>
                        : (const void*)sx_hist_kernel<true, true>;
  return nchains == 1 ? (const void*)sx_hist_kernel<false, false>
                      : (const void*)sx_hist_kernel<true, false>;
}

// B3/B4 forms (bits of form): tril proposals, weighted samples, tempered
// replicas, experiment-grouped chains.  Tempered proposals are diagonal
// and never grouped.
#define SX_TRIL 1
#define SX_WEIGHTED 2
#define SX_TEMPERED 4
#define SX_GROUPED 8

template <bool kChains, bool kW>
static const void* sx_fused_fn_w(int form) {
  const bool tril = (form & SX_TRIL) != 0;
  if (form & SX_GROUPED) {
    if (form & SX_TEMPERED) return nullptr;
    return tril ? (const void*)sx_fused_kernel<true, true, kW, false, true>
                : (const void*)sx_fused_kernel<true, false, kW, false, true>;
  }
  if (form & SX_TEMPERED)
    return tril ? nullptr
                : (const void*)sx_fused_kernel<kChains, false, kW, true, false>;
  return tril ? (const void*)sx_fused_kernel<kChains, true, kW, false, false>
              : (const void*)sx_fused_kernel<kChains, false, kW, false, false>;
}

static const void* sx_fused_fn(int nchains, int form) {
  const bool w = (form & SX_WEIGHTED) != 0;
  if (nchains == 1 && !(form & SX_GROUPED))
    return w ? sx_fused_fn_w<false, true>(form)
             : sx_fused_fn_w<false, false>(form);
  return w ? sx_fused_fn_w<true, true>(form)
           : sx_fused_fn_w<true, false>(form);
}

static const void* sx_blocked_fn(int nchains, bool grouped) {
  if (grouped) return (const void*)sx_blocked_kernel<true, true>;
  return nchains == 1 ? (const void*)sx_blocked_kernel<false, false>
                      : (const void*)sx_blocked_kernel<true, false>;
}

// Blocks of fn resident on one SM with this spec's shared memory.
static cudaError_t sx_occupancy(const SxSpec& sp, int nchains, bool weighted,
                                const void* fn, int* occ) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  const int nrep = sx_replicas(sp, nchains, weighted);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      occ, fn, SX_THREADS, sx_smem_bytes(sp, nchains, nrep, weighted));
}

// The grid rule of the persistent kernels (B4 and B5), given the blocks
// per SM that the kernel's resources allow.  More resident blocks hide
// more of the rebuild's latency, but every block adds to the grid
// barriers and the reductions of each step.  Measured on an H100
// (probe_fused_grid.py, PERF.md), the best grid gives each thread about
// two MC rows to load per step, 1 to 4 blocks per SM: with one chain 1
// block per SM at 20k rows, 2-3 at 200k, 3-4 at 1M; with 8 lock-step
// chains 1 at 20k, 3 at 200k, 4 at 1M (and 4 for 32 chains at 1M).  A
// lock-step thread bins each row it loads for every chain, so the rule
// counts rows, not binnings: counting binnings, as the rule did before
// the binning kept rows in registers, took 3 blocks per SM at 20k rows x
// 8 chains and 4 at 200k, 14% and 9% slower than the best.
static cudaError_t sx_grid_rule(const SxSpec& sp, int occ, int* nblocks) {
  int nsm = 0;
  cudaError_t err = sx_num_sms(&nsm);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  // MC rows one block on every SM covers at two per thread.
  const long long layer = 2LL * nsm * SX_THREADS;
  const long long work = (long long)sp.seg_off[sp.ndyn];
  long long per_sm = (work + layer - 1) / layer;
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  *nblocks = nsm * (int)(per_sm < occ ? per_sm : occ);
  return cudaSuccess;
}

// Launch a persistent cooperative kernel fn on nblocks blocks, which must
// all be resident at once.
static cudaError_t sx_cooperative(const SxSpec& sp, int nchains,
                                  bool weighted, const void* fn,
                                  int nblocks, void** args, int smem,
                                  cudaStream_t st) {
  int nsm = 0, occ = 0;
  cudaError_t err = sx_num_sms(&nsm);
  if (err != cudaSuccess) return err;
  if ((err = sx_occupancy(sp, nchains, weighted, fn, &occ)) != cudaSuccess)
    return err;
  if (nblocks < 1 || nblocks > nsm * occ)
    return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(fn, dim3(nblocks), dim3(SX_THREADS),
                                    args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One launch's chains within the static arrays' caps; grouped (cpe > 0)
// chains come in whole experiments of cpe chains.
static bool sx_chains_fit(const SxSpec& sp, int nchains, int cpe) {
  return nchains >= 1 && nchains <= SX_MAXCHAINS &&
         nchains * sp.npar <= SX_MAXCP && nchains * sp.nsig <= SX_MAXCS &&
         cpe >= 0 && (cpe == 0 || nchains % cpe == 0);
}

// ------------------------------------------------------ C interface

extern "C" {

int sx_spec_size() { return (int)sizeof(SxSpec); }

const char* sx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// B1: par holds nchains parameter vectors pstride apart; weighted
// samples carry their weight row after the nfields fields.  scratch
// holds nchains * (ndyn * total + ndyn) unsigned ints (float64 when
// weighted); out as many float32: the (nchains, ndyn, total) counts,
// then the (nchains, ndyn) in-domain counts (weight sums when weighted).
int sx_histogram(const SxSpec* sp, int nchains, int weighted,
                 const float* samples, const float* par, int pstride,
                 void* scratch, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nchains < 1 || nchains > SX_MAXCHAINS || pstride < 0 ||
      pstride > SX_MAXPAR)
    return cudaErrorInvalidValue;
  const bool w = weighted != 0;
  const int nh = nchains * sp->ndyn * sp->total;
  const int nall = nh + nchains * sp->ndyn;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)sx_cell_bytes(w) * nall, st);
  if (err != cudaSuccess) return err;
  const int nrep = sx_replicas(*sp, nchains, w);
  const int smem = sx_smem_bytes(*sp, nchains, nrep, w);
  int nsm = 0, occ = 0;
  if ((err = sx_num_sms(&nsm)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, sx_hist_fn(nchains, w), SX_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long n = sp->seg_off[sp->ndyn];
  long long blocks = (long long)nsm * (occ < 4 ? occ : 4);
  const long long need = (n + SX_THREADS - 1) / SX_THREADS;
  if (need < blocks) blocks = need > 0 ? need : 1;
  const int nb = (int)blocks;
  const int cb = (nall + 255) / 256;
  if (w) {
    double* acc = static_cast<double*>(scratch);
    if (nchains == 1)
      sx_hist_kernel<false, true><<<nb, SX_THREADS, smem, st>>>(
          *sp, samples, par, 1, pstride, acc, acc + nh, nrep);
    else
      sx_hist_kernel<true, true><<<nb, SX_THREADS, smem, st>>>(
          *sp, samples, par, nchains, pstride, acc, acc + nh, nrep);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sx_to_float<double><<<cb, 256, 0, st>>>(acc, out, nall);
  } else {
    unsigned* acc = static_cast<unsigned*>(scratch);
    if (nchains == 1)
      sx_hist_kernel<false, false><<<nb, SX_THREADS, smem, st>>>(
          *sp, samples, par, 1, pstride, acc, acc + nh, nrep);
    else
      sx_hist_kernel<true, false><<<nb, SX_THREADS, smem, st>>>(
          *sp, samples, par, nchains, pstride, acc, acc + nh, nrep);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sx_to_float<unsigned><<<cb, 256, 0, st>>>(acc, out, nall);
  }
  return cudaGetLastError();
}

// B2: counts (nseg, total), norms (nseg,), rb (rb_rows, nev) with nseg
// a multiple of rb_rows -> out (nseg, nev).
int sx_eval_lut(const float* counts, const float* norms, const int* rb,
                int nseg, int rb_rows, int total, long long nev,
                float bin_volume, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rb_rows < 1 || nseg % rb_rows != 0 || total < 1)
    return cudaErrorInvalidValue;
  if (nseg == 0 || nev == 0) return cudaSuccess;
  const long long blocks = (nev + 256 * kLutPer - 1) / (256 * kLutPer);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, nseg < 65535 ? nseg : 65535);
  sx_eval_lut_kernel<<<grid, 256, 0, st>>>(counts, norms, rb, nseg, rb_rows,
                                           total, nev, bin_volume, out);
  return cudaGetLastError();
}

// Grid size of sx_fused (every proposal form of this weightedness) for
// this spec and chain count: the number of partial slots per chain
// (sx_grid_rule).
int sx_fused_grid(const SxSpec* sp, int nchains, int weighted,
                  int* nblocks) {
  const bool w = weighted != 0;
  const int base = w ? SX_WEIGHTED : 0;
  int occ = 0x7fffffff;
  for (int form : {base, base | SX_TRIL, base | SX_TEMPERED}) {
    int o = 0;
    cudaError_t err =
        sx_occupancy(*sp, nchains, w, sx_fused_fn(nchains, form), &o);
    if (err != cudaSuccess) return err;
    if (o < occ) occ = o;
  }
  return sx_grid_rule(*sp, occ, nblocks);
}

// B3 (nsteps == 0: NLL of each chain at params0 into nlls_out (nchains,
// 2)) and B4 (nsteps > 0: a whole fixed-width segment; histories
// (nsteps, nchains, npar), (nsteps, nchains, 2), (nsteps, nchains)).
// form: SX_TRIL (width the (nchains, npar, npar) lower-triangular
// scales, else (nchains, npar) widths), SX_WEIGHTED (the samples carry
// their weight row), SX_TEMPERED (beta the (nchains,) inverse
// temperatures; else beta is unused).  cpe > 0 takes the experiment-
// grouped form (B4 only, not tempered): rb holds (nchains / cpe, nsig,
// nev) read bins and chain c reads experiment c / cpe's; cpe == 0 is
// one dataset's (nsig, nev) for every chain.  scratch holds 2 * nchains
// * (ndyn * total + ndyn) unsigned ints (float64 when weighted),
// partials nchains * nblocks doubles (sx_fused_grid).
int sx_fused(const SxSpec* sp, int nchains, int cpe, int form,
             const float* samples, const float* hist_init, const int* rb,
             int nev, const float* params0, const float* nll0,
             const float* width, const float* beta, const float* noise,
             const float* log_u, int nsteps, int debug, void* scratch,
             double* partials, int nblocks, float* samples_out,
             float* nlls_out, float* acc_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cpe > 0) form |= SX_GROUPED;
  const void* fn = sx_fused_fn(nchains, form);
  if (!sx_chains_fit(*sp, nchains, cpe) || fn == nullptr ||
      ((form & (SX_TRIL | SX_TEMPERED | SX_GROUPED)) && nsteps < 1))
    return cudaErrorInvalidValue;
  const bool w = (form & SX_WEIGHTED) != 0;
  const int buf = nchains * (sp->ndyn * sp->total + sp->ndyn);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, 2 * (size_t)sx_cell_bytes(w) * buf, st);
  if (err != cudaSuccess) return err;
  int nrep = sx_replicas(*sp, nchains, w);
  SxSpec spv = *sp;
  void* args[] = {(void*)&spv,      (void*)&nchains,  (void*)&samples,
                  (void*)&hist_init, (void*)&rb,      (void*)&nev,
                  (void*)&cpe,      (void*)&params0,  (void*)&nll0,
                  (void*)&width,    (void*)&beta,     (void*)&noise,
                  (void*)&log_u,
                  (void*)&nsteps,   (void*)&debug,    (void*)&scratch,
                  (void*)&partials, (void*)&samples_out, (void*)&nlls_out,
                  (void*)&acc_out,  (void*)&nrep};
  return sx_cooperative(*sp, nchains, w, fn, nblocks, args,
                        sx_smem_bytes(*sp, nchains, nrep, w), st);
}

// Grid size of sx_blocked (sx_grid_rule).
int sx_blocked_grid(const SxSpec* sp, int nchains, int* nblocks) {
  int occ = 0;
  cudaError_t err =
      sx_occupancy(*sp, nchains, false, sx_blocked_fn(nchains, false), &occ);
  if (err != cudaSuccess) return err;
  return sx_grid_rule(*sp, occ, nblocks);
}

// B5: ncycles blocked cycles of nsub >= 2 decisions (one systematic
// move, nsub - 1 rate moves), unweighted samples.  width (nchains,
// npar), noise (ncycles, nsub, nchains, npar), log_u (ncycles, nsub,
// nchains); histories (ncycles, nchains, npar), (ncycles, nchains, 2)
// and the accepted fraction (ncycles, nchains).  cpe > 0: experiment-
// grouped read bins, as sx_fused's.  scratch holds 2 * nchains * (ndyn
// * total + ndyn) unsigned ints, partials 2 * nchains * nblocks doubles
// (sx_blocked_grid).
int sx_blocked(const SxSpec* sp, int nchains, int cpe, const float* samples,
               const float* hist_init, const int* rb, int nev,
               const float* params0, const float* nll0, const float* width,
               const float* noise, const float* log_u, int ncycles, int nsub,
               int debug, unsigned* scratch, double* partials, int nblocks,
               float* samples_out, float* nlls_out, float* acc_out,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!sx_chains_fit(*sp, nchains, cpe) || ncycles < 1 || nsub < 2)
    return cudaErrorInvalidValue;
  const int buf = nchains * (sp->ndyn * sp->total + sp->ndyn);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned) * buf, st);
  if (err != cudaSuccess) return err;
  int nrep = sx_replicas(*sp, nchains, false);
  SxSpec spv = *sp;
  void* args[] = {(void*)&spv,      (void*)&nchains,  (void*)&samples,
                  (void*)&hist_init, (void*)&rb,      (void*)&nev,
                  (void*)&cpe,      (void*)&params0,  (void*)&nll0,
                  (void*)&width,    (void*)&noise,    (void*)&log_u,
                  (void*)&ncycles,
                  (void*)&nsub,     (void*)&debug,    (void*)&scratch,
                  (void*)&partials, (void*)&samples_out, (void*)&nlls_out,
                  (void*)&acc_out,  (void*)&nrep};
  return sx_cooperative(*sp, nchains, false, sx_blocked_fn(nchains, cpe > 0),
                        nblocks, args,
                        sx_smem_bytes(*sp, nchains, nrep, false), st);
}

}  // extern "C"
