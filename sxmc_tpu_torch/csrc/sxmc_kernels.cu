// Hand-written Hopper (sm_90a) kernels of sxmc_tpu_torch, with a plain C
// interface loaded through ctypes (sxmc_tpu_torch/ops/kernels.py).
//
// B1  sx_histogram     replaces sxmc_tpu/ops/pallas_hist.py::
//                      pallas_histogram_segmented (single-theta form).
// B3  sx_fused (nsteps == 0)
//                      replaces sxmc_tpu/ops/pallas_step.py::pallas_fused_step.
// B4  sx_fused (nsteps > 0)
//                      replaces sxmc_tpu/ops/pallas_step.py::
//                      pallas_fused_segment (single-chain diagonal form).
//
// B1 -- what bounds it.  Per sample it reads nfields floats (12 bytes on
// the reference example), does a few float ops and one atomic increment:
// a memory-bound pass, except that at few bins (the example has 10)
// every warp hits the same few counters.  Design: one privatised
// unsigned histogram per warp group in shared memory (up to 8 replicas
// per block, chosen to fit 40 KB), flushed with one global atomicAdd per
// nonzero cell; measured on an H100, the rebuild then costs about the
// same at 10 bins as at 1000.  The TPU's two-level one-hot matmul,
// trash cell and chunk padding exist only because the TPU has no
// atomics; they are not carried over.  Segments are addressed by
// offsets, not padding.
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
//             fixed slot                                   -- grid.sync
//   finish + accept (every block reduces the slots in the same fixed
//             order and takes the same decision; block 0 writes the
//             history)
// Taking the decision in every block saves the third barrier a
// broadcast from block 0 would need.  Sums are float64 (the H100 has
// native f64; the TPU needed compensated f32 pairs), reduced in a fixed
// order, so the result is the same from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sxmc_phases.cuh"

namespace cg = cooperative_groups;

static const int kSmemBudget = 40 * 1024;

// Shared-memory histogram replicas that fit the budget (0: use global).
static int sx_replicas(const SxSpec& sp) {
  const long long per = 4LL * sp.ndyn * sp.total;
  const long long norm = 4LL * sp.ndyn;
  if (per == 0 || per + norm > kSmemBudget) return 0;
  long long r = (kSmemBudget - norm) / per;
  const int warps = SX_THREADS / 32;
  return (int)(r < warps ? r : warps);
}

static int sx_smem_bytes(const SxSpec& sp, int nrep) {
  return 4 * (nrep * sp.ndyn * sp.total + sp.ndyn);
}

static cudaError_t sx_num_sms(int* nsm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
}

// ---------------------------------------------------------------- B1

__global__ void __launch_bounds__(SX_THREADS)
sx_hist_kernel(const SxSpec sp, const float* __restrict__ samples,
               const float* __restrict__ par, unsigned* g_hist,
               unsigned* g_norm, int nrep) {
  extern __shared__ unsigned sh[];
  const int nh = sp.ndyn * sp.total;
  unsigned* sh_norm = sh + nrep * nh;
  for (int t = threadIdx.x; t < nrep * nh + sp.ndyn; t += blockDim.x)
    sh[t] = 0u;
  __syncthreads();
  sx_accumulate(sp, samples, par, sh, sh_norm, g_hist, nrep);
  __syncthreads();
  sx_flush(sp, sh, sh_norm, nrep, g_hist, g_norm);
}

__global__ void sx_to_float(const unsigned* __restrict__ in,
                            float* __restrict__ out, int n) {
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x)
    out[t] = (float)in[t];
}

// ------------------------------------------------------------- B3/B4

__global__ void __launch_bounds__(SX_THREADS)
sx_fused_kernel(const SxSpec sp, const float* __restrict__ samples,
                const float* __restrict__ hist_init,
                const int* __restrict__ rb, int nev,
                const float* __restrict__ params0,
                const float* __restrict__ nll0,
                const float* __restrict__ width,
                const float* __restrict__ noise,
                const float* __restrict__ log_u, int nsteps, int debug,
                unsigned* scratch, double* partials, float* samples_out,
                float* nlls_out, float* acc_out, int nrep) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned sh[];
  __shared__ float s_cur[SX_MAXPAR];
  __shared__ float s_prop[SX_MAXPAR];
  __shared__ float s_w[SX_MAXSIG];
  __shared__ float s_norm[SX_MAXSIG];
  __shared__ float s_cur_pair[2];
  __shared__ int s_accept;
  __shared__ double s_red[SX_THREADS];

  const int tid = threadIdx.x;
  const int nh = sp.ndyn * sp.total;
  const int buf = nh + sp.ndyn;  // one histogram buffer + its norms
  unsigned* sh_norm = sh + nrep * nh;
  const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const bool eval_only = nsteps == 0;
  const int nrun = eval_only ? 1 : nsteps;

  if (tid < sp.npar) s_cur[tid] = params0[tid];
  if (tid == 0 && !eval_only) {
    s_cur_pair[0] = nll0[0];
    s_cur_pair[1] = nll0[1];
  }
  __syncthreads();

  for (int s = 0; s < nrun; ++s) {
    unsigned* cur_hist = scratch + (s & 1) * buf;
    unsigned* cur_norm = cur_hist + nh;
    unsigned* next_hist = scratch + ((s + 1) & 1) * buf;

    // Propose: metropolis._make_step's op order, noise * max(w, 0);
    // w <= 0 pins the parameter.
    if (tid < sp.npar) {
      const float c = s_cur[tid];
      if (eval_only) {
        s_prop[tid] = c;
      } else {
        const float w = width[tid];
        const float nz =
            noise[(long long)s * sp.npar + tid] * fmaxf(w, 0.0f);
        s_prop[tid] = (w > 0.0f) ? c + nz : c;
      }
    }
    for (int t = tid; t < nrep * nh + sp.ndyn; t += blockDim.x) sh[t] = 0u;
    // The buffer of step s - 1 is free again: clear it for step s + 1.
    for (long long t = gtid; t < buf; t += gstride) next_hist[t] = 0u;
    __syncthreads();

    // Rebuild the dynamic histograms at the proposal.
    sx_accumulate(sp, samples, s_prop, sh, sh_norm, cur_hist, nrep);
    __syncthreads();
    sx_flush(sp, sh, sh_norm, nrep, cur_hist, cur_norm);
    grid.sync();

    // Norms and per-signal weights ((rate * nexpected) * norm) / n_mc.
    if (tid < sp.nsig) {
      const int slot = sp.sig_slot[tid];
      const float norm = slot >= 0 ? (float)__ldcg(&cur_norm[slot])
                                   : sp.norm_init[tid];
      const float rate = s_prop[sp.source_id[tid]];
      s_norm[tid] = norm;
      s_w[tid] = ((rate * sp.nexpected[tid]) * norm) / sp.n_mc[tid];
    }
    __syncthreads();

    // Events: LUT gather with the -1/-2 sentinels (both give 0 here, as
    // nll_pair's nan_to_num makes them), the mix in ascending signal
    // order, log where positive; f64 accumulation.
    double acc = 0.0;
    for (long long i = gtid; i < nev; i += gstride) {
      float mix = 0.0f;
      for (int j = 0; j < sp.nsig; ++j) {
        const int b = rb[(long long)j * nev + i];
        float val = 0.0f;
        if (b >= 0) {
          const int slot = sp.sig_slot[j];
          const float cnt =
              slot >= 0 ? (float)__ldcg(&cur_hist[slot * sp.total + b])
                        : hist_init[j * sp.total + b];
          val = cnt / (s_norm[j] * sp.bin_volume);
          if (!isfinite(val)) val = 0.0f;
        }
        const float term = s_w[j] * val;
        mix = (j == 0) ? term : mix + term;
      }
      if (mix > 0.0f) acc += (double)logf(mix);
    }
    s_red[tid] = acc;
    __syncthreads();
    for (int h = SX_THREADS / 2; h > 0; h >>= 1) {
      if (tid < h) s_red[tid] += s_red[tid + h];
      __syncthreads();
    }
    if (tid == 0) partials[blockIdx.x] = s_red[0];
    grid.sync();

    // Every block: the same fixed-order reduction, finish and decision.
    if (tid < 32) {
      double v = 0.0;
      for (int b = tid; b < (int)gridDim.x; b += 32) v += __ldcg(&partials[b]);
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (tid == 0) {
        const float ev_hi = (float)v;
        const float ev_lo = (float)(v - (double)ev_hi);
        double wsum = 0.0;
        for (int j = 0; j < sp.nsig; ++j) wsum += (double)s_w[j];
        double con = 0.0;
        bool neg_rate = false;
        for (int k = 0; k < sp.npar; ++k) {
          if (sp.sigmas[k] > 0.0f) {
            const float z = (s_prop[k] - sp.means[k]) / sp.sigmas[k];
            con += (double)(z * z);
          }
          if (k < sp.nsources && s_prop[k] < 0.0f) neg_rate = true;
        }
        const double ev = (double)ev_hi + (double)ev_lo;
        const double total = -ev + wsum + 0.5 * con;
        float hi = (float)total;
        float lo = (float)(total - (double)hi);
        if (neg_rate || !isfinite(ev_hi)) {
          hi = 1e18f;
          lo = 0.0f;
        }
        if (eval_only) {
          if (blockIdx.x == 0) {
            nlls_out[0] = hi;
            nlls_out[1] = lo;
          }
        } else {
          // df_diff's op order, then the log-space accept of the TPU
          // kernel: log(u) <= delta (pallas_step.py:782-792).
          const float delta = (s_cur_pair[0] - hi) + (s_cur_pair[1] - lo);
          const bool a = debug || delta > 0.0f || log_u[s] <= delta;
          s_accept = a ? 1 : 0;
          if (a) {
            s_cur_pair[0] = hi;
            s_cur_pair[1] = lo;
          }
          if (blockIdx.x == 0) {
            nlls_out[2LL * s] = s_cur_pair[0];
            nlls_out[2LL * s + 1] = s_cur_pair[1];
            acc_out[s] = a ? 1.0f : 0.0f;
          }
        }
      }
    }
    __syncthreads();
    if (!eval_only && tid < sp.npar) {
      if (s_accept) s_cur[tid] = s_prop[tid];
      if (blockIdx.x == 0)
        samples_out[(long long)s * sp.npar + tid] = s_cur[tid];
    }
    __syncthreads();
  }
}

// ------------------------------------------------------ C interface

extern "C" {

int sx_spec_size() { return (int)sizeof(SxSpec); }

const char* sx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// B1: scratch holds ndyn * total + ndyn unsigned ints; out is
// ndyn * total + ndyn float32: the (ndyn, total) counts, then each
// segment's in-domain count.
int sx_histogram(const SxSpec* sp, const float* samples, const float* par,
                 unsigned* scratch, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nh = sp->ndyn * sp->total;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(unsigned) * (nh + sp->ndyn), st);
  if (err != cudaSuccess) return err;
  const int nrep = sx_replicas(*sp);
  const int smem = sx_smem_bytes(*sp, nrep);
  int nsm = 0, occ = 0;
  if ((err = sx_num_sms(&nsm)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sx_hist_kernel,
                                                      SX_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long n = sp->seg_off[sp->ndyn];
  long long blocks = (long long)nsm * (occ < 4 ? occ : 4);
  const long long need = (n + SX_THREADS - 1) / SX_THREADS;
  if (need < blocks) blocks = need > 0 ? need : 1;
  sx_hist_kernel<<<(int)blocks, SX_THREADS, smem, st>>>(
      *sp, samples, par, scratch, scratch + nh, nrep);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sx_to_float<<<(nh + sp->ndyn + 255) / 256, 256, 0, st>>>(
      scratch, out, nh + sp->ndyn);
  return cudaGetLastError();
}

// Grid size of sx_fused for this spec (the number of partial slots).
// More resident blocks hide more of the rebuild's read latency, but
// every block adds to the two grid barriers and the partial reduction
// of each step.  Measured on an H100 (see PERF.md), the best grid
// gives each thread about two samples per step, up to 4 blocks per SM
// (8 was slower at 1M samples): 1 block per SM at 20k samples, 3 at
// 200k, 4 at 1M and 4M.
int sx_fused_grid(const SxSpec* sp, int* nblocks) {
  const int nrep = sx_replicas(*sp);
  int nsm = 0, occ = 0;
  cudaError_t err = sx_num_sms(&nsm);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, sx_fused_kernel, SX_THREADS, sx_smem_bytes(*sp, nrep));
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  // Samples one block on every SM covers at two per thread.
  const long long layer = 2LL * nsm * SX_THREADS;
  long long per_sm = (sp->seg_off[sp->ndyn] + layer - 1) / layer;
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  *nblocks = nsm * (int)(per_sm < occ ? per_sm : occ);
  return cudaSuccess;
}

// B3 (nsteps == 0: NLL at params0 into nlls_out[0..1]) and B4 (nsteps >
// 0: a whole fixed-width segment).  scratch holds 2 * (ndyn * total +
// ndyn) unsigned ints, partials nblocks doubles (sx_fused_grid).
int sx_fused(const SxSpec* sp, const float* samples, const float* hist_init,
             const int* rb, int nev, const float* params0, const float* nll0,
             const float* width, const float* noise, const float* log_u,
             int nsteps, int debug, unsigned* scratch, double* partials,
             int nblocks, float* samples_out, float* nlls_out,
             float* acc_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nh = sp->ndyn * sp->total;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, 2 * sizeof(unsigned) * (nh + sp->ndyn), st);
  if (err != cudaSuccess) return err;
  int grid_ok = 0;
  if ((err = (cudaError_t)sx_fused_grid(sp, &grid_ok)) != cudaSuccess)
    return err;
  if (nblocks > grid_ok) return cudaErrorCooperativeLaunchTooLarge;
  int nrep = sx_replicas(*sp);
  const int smem = sx_smem_bytes(*sp, nrep);
  SxSpec spv = *sp;
  void* args[] = {(void*)&spv,     (void*)&samples,   (void*)&hist_init,
                  (void*)&rb,      (void*)&nev,       (void*)&params0,
                  (void*)&nll0,    (void*)&width,     (void*)&noise,
                  (void*)&log_u,   (void*)&nsteps,    (void*)&debug,
                  (void*)&scratch, (void*)&partials,  (void*)&samples_out,
                  (void*)&nlls_out, (void*)&acc_out,  (void*)&nrep};
  err = cudaLaunchCooperativeKernel((const void*)sx_fused_kernel,
                                    dim3(nblocks), dim3(SX_THREADS), args,
                                    smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
