// Hand-written Hopper (sm_90a) kernels of sxmc_tpu_torch, with a plain C
// interface loaded through ctypes (sxmc_tpu_torch/ops/kernels.py).
//
// B1  sx_histogram     (sxmc_hist.cu) replaces sxmc_tpu/ops/pallas_hist.py::
//                      pallas_histogram_segmented and pallas_histogram.
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
// B2 -- what bounds it.  out[s, i] = counts[s, rb[s % rows, i]] /
// (norms[s] * bin_volume): the bytes, a read bin read once per read-bin
// row and a float32 written once per table row (the chains x signals
// rows of a batched evaluation share the signals' read-bin rows); the
// table is small and the work a value a lookup.  Design: each block
// stages its table row's quotients in shared memory once (the same IEEE
// division as torch's, so the bits do not change), the first tile's read
// bins already in flight, then sweeps tiles of read bins on a grid sized
// from the SM count, 16-byte loads and 16-byte streaming stores: no
// division a value.  One table row a block: the other rows' blocks read
// the same read-bin row again, from L2.  Blocks that wrote every row
// sharing a read-bin row from one load of it measured slower on an H100
// at every shape (their prologue stages every row's table; PERF.md).  A
// row's table too large for the shared-memory budget takes the L1 form
// of the same kernel (the counts read through L1, a division a value).
// The TPU's one-hot matmul exists only because XLA's gather is slow on a
// TPU; it is not carried over.
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

#include <cuda_runtime.h>

#include <initializer_list>

#include "sxmc_fused.cuh"

// Dynamic shared memory for histogram replicas; with sx_fused_kernel's
// and sx_blocked_kernel's up to ~8.8 KB of static arrays a block stays
// under the 48 KB a launch gets without an opt-in.
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

// ---------------------------------------------------------------- B2

// B2's plan (mirrored by _CLutPlan in sxmc_tpu_torch/ops/kernels.py),
// made once per read-bins tensor and table shape: rb (rows, nev) int32
// and nseg table rows of total bins, row s reading rb row s % rows; the
// form (staged: the row's quotients in shared memory; else the L1 form)
// and the int4s of read bins a thread loads a tile (vecs, 1 or 4); the
// grid (gx, gy) and the dynamic shared memory (4 * total bytes, staged).
struct SxLutPlan {
  const int* rb;
  long long nev;
  int rows, nseg, total, staged, vecs, gx, gy, smem;
  float bin_volume;
};

static const int kLutThreads = 256;

// One tile's read bins: int4 v = t * kLutThreads * V + u * kLutThreads +
// tid of the row's aligned body; past its end, -2 (not written).
template <int V>
__device__ __forceinline__ void sx_lut_load(int4 (&b)[V],
                                            const int4* __restrict__ vrow,
                                            long long t, long long nvec) {
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const long long v = (t * V + u) * kLutThreads + threadIdx.x;
    b[u] = v < nvec ? vrow[v] : make_int4(-2, -2, -2, -2);
  }
}

// The value of read bin `bin`: -1 -> the canonical quiet NaN (as
// torch's), -2 -> 0, else the quotient of the bin clamped to the table
// (as the plain version's gather): from the staged row q, or (L1 form)
// the counts over the row's denominator.
template <bool kStaged>
__device__ __forceinline__ float sx_lut_value(const float* q,
                                              const float* __restrict__ cnt,
                                              float den, int total,
                                              int bin) {
  if (bin == -1) return __int_as_float(0x7fc00000);
  if (bin == -2) return 0.0f;
  const int j = min(max(bin, 0), total - 1);
  return kStaged ? q[j] : cnt[j] / den;
}

// Four consecutive outputs, stored streaming (evict first: the LUT is
// written once and read by the caller's next kernel, the read bins and
// the table stay in cache): one 16-byte store where the address allows
// it (always when nev % 4 == 0), else four.
__device__ __forceinline__ void sx_lut_store(float* dst, float4 o) {
  if (((uintptr_t)dst & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(dst), o);
  } else {
    __stcs(dst, o.x);
    __stcs(dst + 1, o.y);
    __stcs(dst + 2, o.z);
    __stcs(dst + 3, o.w);
  }
}

// out[s, i] = counts[s, rb[s % rows, i]] / (norms[s] * bin_volume), -1
// -> NaN, -2 -> 0: block row y writes table row s = y (and s + gridDim.y,
// ...).  The staged form first stages the row's quotients (the same IEEE
// division as the plain version), the first tile's read bins already in
// flight.  The read-bin row is cut into a head (up to its first 16-byte
// boundary), a body of int4s and a tail; the body is swept in tiles of V
// int4s a thread, tile t by block t % gridDim.x, the next tile's loads in
// flight while this one is written.
template <bool kStaged, int V>
__global__ void __launch_bounds__(kLutThreads)
    sx_eval_lut_kernel(const float* __restrict__ counts,
                       const float* __restrict__ norms, const SxLutPlan p,
                       float* __restrict__ out) {
  extern __shared__ float q[];  // the staged row
  for (int s = blockIdx.y; s < p.nseg; s += gridDim.y) {
    const int* row = p.rb + (long long)(s % p.rows) * p.nev;
    const long long head = min(
        (long long)((4 - (int)(((uintptr_t)row >> 2) & 3)) & 3), p.nev);
    const long long nvec = (p.nev - head) >> 2;
    const long long tail0 = head + 4 * nvec;
    const int4* vrow = reinterpret_cast<const int4*>(row + head);
    const float* cnt = counts + (long long)s * p.total;
    float* orow = out + (long long)s * p.nev;
    int4 cur[V];
    long long t = blockIdx.x;
    sx_lut_load<V>(cur, vrow, t, nvec);
    const float den = norms[s] * p.bin_volume;
    if (kStaged) {
      if (s != (int)blockIdx.y) __syncthreads();  // the last row's readers
      for (int j = threadIdx.x; j < p.total; j += kLutThreads)
        q[j] = cnt[j] / den;
      __syncthreads();
    }
    // Head and tail: at most three values each, block 0 of the row.
    if (blockIdx.x == 0 && threadIdx.x < 8) {
      const long long i = threadIdx.x < 4 ? (long long)threadIdx.x
                                          : tail0 + threadIdx.x - 4;
      if ((threadIdx.x < 4 && i < head) || (threadIdx.x >= 4 && i < p.nev))
        orow[i] = sx_lut_value<kStaged>(q, cnt, den, p.total, row[i]);
    }
    for (; t * V * kLutThreads < nvec; t += gridDim.x) {
      int4 nxt[V];
      sx_lut_load<V>(nxt, vrow, t + gridDim.x, nvec);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const long long v = (t * V + u) * kLutThreads + threadIdx.x;
        if (v < nvec) {
          const int4 b = cur[u];
          sx_lut_store(
              orow + head + 4 * v,
              make_float4(sx_lut_value<kStaged>(q, cnt, den, p.total, b.x),
                          sx_lut_value<kStaged>(q, cnt, den, p.total, b.y),
                          sx_lut_value<kStaged>(q, cnt, den, p.total, b.z),
                          sx_lut_value<kStaged>(q, cnt, den, p.total, b.w)));
        }
        cur[u] = nxt[u];
      }
    }
  }
}

// The instantiation of a plan's form and loads.
static const void* sx_lut_fn(int staged, int vecs) {
  if (vecs == 4)
    return staged ? (const void*)sx_eval_lut_kernel<true, 4>
                  : (const void*)sx_eval_lut_kernel<false, 4>;
  return staged ? (const void*)sx_eval_lut_kernel<true, 1>
                : (const void*)sx_eval_lut_kernel<false, 1>;
}

// The instantiation of this layout: the kWide forms when a systematic
// transforms a field past the fourth.
static const void* sx_fused_fn(const SxSpec& sp, int nchains, int form) {
  return sp.nload > SX_MAXOBS ? sx_fused_fn_wide(nchains, form)
                              : sx_fused_fn_t<false>(nchains, form);
}

static const void* sx_blocked_fn(const SxSpec& sp, int nchains,
                                 bool grouped) {
  return sp.nload > SX_MAXOBS ? sx_blocked_fn_wide(nchains, grouped)
                              : sx_blocked_fn_t<false>(nchains, grouped);
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

int sx_lut_plan_size() { return (int)sizeof(SxLutPlan); }

const char* sx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// B2's limits on device dev: its SMs and the shared memory a block may
// opt in to (the plan's budget).
int sx_lut_limits(int dev, int* nsm, int* smem_optin) {
  cudaError_t err =
      cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Blocks of B2's form and loads resident on one SM of the current device
// with smem bytes of dynamic shared memory.  Above 48 KB the form is
// opted in to the most dynamic shared memory the device allows (so that
// a later plan with less still launches); a plan is made with its device
// current, as it is launched.  A failed call's error is taken off the
// runtime's last error, where the next launch's check would find it.
int sx_lut_occupancy(int staged, int vecs, int smem, int* occ) {
  const void* fn = sx_lut_fn(staged, vecs);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    int dev = 0, most = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, fn, kLutThreads,
                                                        smem);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// B2 on plan p: counts (nseg, total), norms (nseg,) -> out (nseg, nev).
int sx_eval_lut(const SxLutPlan* p, const float* counts, const float* norms,
                float* out, void* stream) {
  void* args[] = {(void*)&counts, (void*)&norms, (void*)p, (void*)&out};
  cudaError_t err =
      cudaLaunchKernel(sx_lut_fn(p->staged, p->vecs), dim3(p->gx, p->gy),
                       dim3(kLutThreads), args, p->smem,
                       (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
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
        sx_occupancy(*sp, nchains, w, sx_fused_fn(*sp, nchains, form), &o);
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
  const void* fn = sx_fused_fn(*sp, nchains, form);
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
      sx_occupancy(*sp, nchains, false, sx_blocked_fn(*sp, nchains, false),
                   &occ);
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
  return sx_cooperative(*sp, nchains, false,
                        sx_blocked_fn(*sp, nchains, cpe > 0),
                        nblocks, args,
                        sx_smem_bytes(*sp, nchains, nrep, false), st);
}

}  // extern "C"
