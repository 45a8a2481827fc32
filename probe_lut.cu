// Variants of kernel B2's body for probe_lut.py (built by it into
// build/probe_lut/; not part of the package).  Each writes out[s, i] =
// counts[s, rb[s % rows, i]] / (norms[s] * bin_volume) with the -1 -> NaN
// and -2 -> 0 sentinels, a block writing `group` of the k table rows that
// share one read-bin row, every read bin loaded once a block as int4s (two
// a thread a tile; nev % 4 == 0 here):
//   rows   the quotients staged row-major in shared memory (group * total
//          floats), one 4-byte shared read a value;
//   l1     the counts read through L1, a division a value;
//   bins   the quotients staged bin-major (rows padded to four; entries
//          total and total + 1 hold the sentinels' NaN and 0), one 16-byte
//          shared read gives four rows' values of a bin;
//   stream no lookup: the read bin itself, converted, is stored (the
//          memory traffic alone; its output is not checked);
// each with plain or streaming (st.global.cs) 16-byte stores.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

struct ProbePlan {
  const int* rb;
  long long nev;
  int rows, k, group, total;
  float bin_volume;
};

enum { kRows = 0, kL1 = 1, kBins = 2, kStream = 3 };
static const int kThreads = 256, kVecs = 2, kTile = kThreads * kVecs;

template <bool kCs>
__device__ __forceinline__ void store4(float* d, float4 o) {
  if (kCs)
    __stcs(reinterpret_cast<float4*>(d), o);
  else
    *reinterpret_cast<float4*>(d) = o;
}

__device__ __forceinline__ float pick(const float* q, const float* cnt,
                                      float den, int total, int bin,
                                      bool staged) {
  if (bin == -1) return __int_as_float(0x7fc00000);
  if (bin == -2) return 0.0f;
  const int j = min(max(bin, 0), total - 1);
  return staged ? q[j] : cnt[j] / den;
}

__device__ __forceinline__ int entry(int b, int total) {
  return b == -1 ? total : (b == -2 ? total + 1 : min(max(b, 0), total - 1));
}

template <int kMode, bool kCs>
__global__ void __launch_bounds__(kThreads)
    probe_lut(const float* __restrict__ counts,
              const float* __restrict__ norms, const ProbePlan p,
              float* __restrict__ out) {
  extern __shared__ float4 q4[];
  float* q = reinterpret_cast<float*>(q4);
  __shared__ float den[32];
  const int ngroups = (p.k + p.group - 1) / p.group;
  const int g4 = (p.group + 3) / 4;
  const int tw = p.total + 2;
  for (int y = blockIdx.y; y < p.rows * ngroups; y += gridDim.y) {
    const int r = y / ngroups, c0 = (y % ngroups) * p.group;
    const int nc = min(p.group, p.k - c0);
    const long long nvec = p.nev >> 2, rs = (long long)p.rows * p.nev;
    const int4* vrow =
        reinterpret_cast<const int4*>(p.rb + (long long)r * p.nev);
    float* out0 = out + (r + (long long)c0 * p.rows) * p.nev;
    const float* cnt0 = counts + (r + (long long)c0 * p.rows) * p.total;
    const long long cs = (long long)p.rows * p.total;
    if (y != (int)blockIdx.y) __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kThreads)
      den[c] = norms[r + (long long)(c0 + c) * p.rows] * p.bin_volume;
    __syncthreads();
    if (kMode == kRows || kMode == kBins) {
      const int cw = kMode == kBins ? 4 * g4 : p.group;
      for (int j = threadIdx.x; j < (kMode == kBins ? tw : p.total);
           j += kThreads)
        for (int c = 0; c < cw; ++c) {
          float v = 0.0f;
          if (c < nc) {
            if (j < p.total)
              v = cnt0[c * cs + j] / den[c];
            else if (j == p.total)
              v = __int_as_float(0x7fc00000);
          }
          q[kMode == kBins ? j * cw + c : c * p.total + j] = v;
        }
      __syncthreads();
    }
    for (long long t = blockIdx.x; t * kTile < nvec; t += gridDim.x) {
#pragma unroll
      for (int u = 0; u < kVecs; ++u) {
        const long long v = (t * kVecs + u) * kThreads + threadIdx.x;
        if (v >= nvec) continue;
        const int4 b = vrow[v];
        float* dst = out0 + 4 * v;
        if (kMode == kStream) {
          for (int c = 0; c < nc; ++c)
            store4<kCs>(dst + c * rs, make_float4((float)b.x, (float)b.y,
                                                  (float)b.z, (float)b.w));
        } else if (kMode == kBins) {
          const int e0 = entry(b.x, p.total), e1 = entry(b.y, p.total);
          const int e2 = entry(b.z, p.total), e3 = entry(b.w, p.total);
          for (int g = 0; 4 * g < nc; ++g) {
            const float4 a0 = q4[e0 * g4 + g], a1 = q4[e1 * g4 + g];
            const float4 a2 = q4[e2 * g4 + g], a3 = q4[e3 * g4 + g];
            float* d = dst + 4 * g * rs;
            store4<kCs>(d, make_float4(a0.x, a1.x, a2.x, a3.x));
            if (4 * g + 1 < nc)
              store4<kCs>(d + rs, make_float4(a0.y, a1.y, a2.y, a3.y));
            if (4 * g + 2 < nc)
              store4<kCs>(d + 2 * rs, make_float4(a0.z, a1.z, a2.z, a3.z));
            if (4 * g + 3 < nc)
              store4<kCs>(d + 3 * rs, make_float4(a0.w, a1.w, a2.w, a3.w));
          }
        } else {
          const bool staged = kMode == kRows;
          for (int c = 0; c < nc; ++c) {
            const float* qc = q + c * p.total;
            const float* cc = cnt0 + c * cs;
            store4<kCs>(dst + c * rs,
                        make_float4(pick(qc, cc, den[c], p.total, b.x, staged),
                                    pick(qc, cc, den[c], p.total, b.y, staged),
                                    pick(qc, cc, den[c], p.total, b.z, staged),
                                    pick(qc, cc, den[c], p.total, b.w, staged)));
          }
        }
      }
    }
  }
}

__global__ void probe_empty() {}

typedef CUresult (*LaunchFn)(CUfunction, unsigned, unsigned, unsigned,
                             unsigned, unsigned, unsigned, unsigned, CUstream,
                             void**, void**);

static const void* probe_fn(int mode, int cs) {
  switch (mode * 2 + (cs != 0)) {
    case 0: return (const void*)probe_lut<kRows, false>;
    case 1: return (const void*)probe_lut<kRows, true>;
    case 2: return (const void*)probe_lut<kL1, false>;
    case 3: return (const void*)probe_lut<kL1, true>;
    case 4: return (const void*)probe_lut<kBins, false>;
    case 5: return (const void*)probe_lut<kBins, true>;
    case 6: return (const void*)probe_lut<kStream, false>;
    case 7: return (const void*)probe_lut<kStream, true>;
  }
  return nullptr;
}

extern "C" {

int probe_plan_size() { return (int)sizeof(ProbePlan); }

// Staged shared memory of a mode and group (bytes).
int probe_smem(int mode, int group, int total) {
  if (mode == kRows) return 4 * group * total;
  if (mode == kBins) return 16 * ((group + 3) / 4) * (total + 2);
  return 0;
}

int probe_occupancy(int mode, int cs, int group, int total, int* occ) {
  const int smem = probe_smem(mode, group, total);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(probe_fn(mode, cs),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return cudaGetLastError();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      occ, probe_fn(mode, cs), kThreads, smem);
}

int probe_launch(int mode, int cs, int gx, int gy, const ProbePlan* p,
                 const float* counts, const float* norms, float* out,
                 void* stream) {
  void* args[] = {(void*)&counts, (void*)&norms, (void*)p, (void*)&out};
  cudaError_t err = cudaLaunchKernel(
      probe_fn(mode, cs), dim3(gx, gy), dim3(kThreads), args,
      probe_smem(mode, p->group, p->total), (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// n launches of an empty kernel in a C loop, by the runtime
// (cudaLaunchKernel) or (driver != 0) by cuLaunchKernel, taken from the
// runtime's driver entry point.
int probe_launch_loop(int n, int driver, void* stream) {
  if (!driver) {
    for (int i = 0; i < n; ++i)
      probe_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
    return cudaGetLastError();
  }
  LaunchFn launch = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaFunction_t fn;
  cudaError_t err = cudaGetDriverEntryPoint(
      "cuLaunchKernel", (void**)&launch, cudaEnableDefault, &found);
  if (err == cudaSuccess)
    err = cudaGetFuncBySymbol(&fn, (const void*)probe_empty);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n; ++i)
    if (launch((CUfunction)fn, 1, 1, 1, 32, 1, 1, 0, (CUstream)stream,
               nullptr, nullptr) != CUDA_SUCCESS)
      return cudaErrorLaunchFailure;
  return cudaSuccess;
}

}  // extern "C"
