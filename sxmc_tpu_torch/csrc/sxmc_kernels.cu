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

const char* sx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
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
