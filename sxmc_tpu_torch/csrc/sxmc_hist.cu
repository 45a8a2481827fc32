// B1, the segmented histogram, by hand for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (sxmc_tpu_torch/ops/kernels.py).
//
// sx_histogram replaces sxmc_tpu/ops/pallas_hist.py::
// pallas_histogram_segmented: per dynamic segment the histogram of its
// samples after the masked systematics, and its in-domain norm, at one
// parameter vector (nchains == 1) or at a batch of them (nchains, npar);
// unweighted (exact unsigned counts) and weighted (float64 sums of the
// per-row weights, rounded once to float32).  With one segment it also
// serves pallas_histogram (B1a).
//
// What bounds it.  One theta: one pass over the sample fields that the
// binning reads (8 bytes a row on the reference example), a few float
// operations and one shared-memory atomic a row: the bytes.  A batch of
// thetas reads each row once and bins it for every chain: the binning's
// instructions and its shared atomics.
//
// Design.
//  * Rows in flight.  A block takes chunks of kRows x 256 consecutive
//    rows (over all segments at once) and the grid strides over the
//    chunks; each thread loads its rows of the next chunk before it bins
//    those of the current one, so that while it bins, the next chunk's
//    loads are in flight (one theta: 16 floats a thread of the fields it
//    reads and the weight; lock-step chains 4).  A thread's rows come in
//    runs of kV = min(kRows, 4) consecutive rows, one 4 * kV-byte load
//    per field where the field's rows start aligned (every field when n
//    is a multiple of 4), else 4-byte loads; rows past the end are
//    masked, and a chunk that straddles a segment boundary is binned
//    once per segment it touches, its other rows masked.  With one
//    4-byte load in flight per thread the grid kept about 0.5 MB in
//    flight, where the card's bandwidth at its load latency needs some
//    2.3 MB (Little's law): the one-theta forms read about a fifth of
//    the bandwidth.  Measured on an H100 (bench_turns.py --skip-turns,
//    10M rows of one field): 4-byte loads read and binned them at about
//    1.7 TB/s however many were in flight (8 or 16 floats a thread in
//    registers, or 16 staged through a shared-memory ring with
//    cp.async); runs of 4 rows in 16-byte loads at about 2.1 TB/s.
//  * Only what the binning reads.  A row's register slots hold its first
//    nload fields (the observables, then the fields a systematic
//    transforms: any of the eight, as in the JAX package) and then the
//    second field of each resolution systematic that lies past them
//    (SxRead, made on the host).
//  * The binning, systematic by systematic over a chunk.  The items of
//    a chunk (its rows, times kGroup lock-step chains) are transformed
//    together: each systematic's uniform branches (in range, masked, its
//    kind, its powers) run once per chunk and chain group, not once per
//    binning.  A one-parameter systematic's p = 0 + theta * 1 and 1 + p
//    are computed once per block and chain into shared memory, in the
//    row code's operations, so the same bits as row by row.
//  * Counts in shared memory.  Thread t adds to slot t % nslot of the
//    block's counts (slots nslot, each a copy of every chain's
//    histograms, slot-major with a stride of 1 mod 32 words so that two
//    slots' copies of one cell lie in different banks): the lanes of a
//    warp share a cell's address only when nslot < 32.  Measured on an
//    H100, 1, 8 or 32 slots cost the unsigned forms the same; one slot
//    made the float64 forms, whose atomics conflict longer, 2.6 times
//    slower.  When even one slot does not fit the budget, every count is
//    a global atomic (nslot == 0).
//  * The grid: as many blocks as fit on the card at once (or as there
//    are chunks).  Measured on an H100: fewer blocks, each with the same
//    number of chunks, took as long at 10 bins and ~2 us longer at
//    1,000 (of ~26), though every block's slots cost a flush of global
//    atomics.
//  * One launch.  Each block adds its slots into a persistent
//    accumulator (unsigned counts or float64 sums; the wrapper keeps one
//    per device and stream, zeroed once when it makes it), then takes a
//    ticket; the last block to take one writes the float32 bins and the
//    norms (each the sum of its row of bins: an in-domain row lands in
//    exactly one bin), and leaves the accumulator and the ticket zeroed
//    for the next call.  No memset, no second kernel, and no runtime
//    query per call: sx_hist_grid picks the grid and the slots once per
//    layout, and the wrapper keeps them.
//
// The TPU kernel's two-level one-hot matmul, trash cell and chunk
// padding exist only because the TPU has no atomics; they are not
// carried over.  Segments are addressed by offsets, not padding.
//
// Arithmetic: the float operations of sxmc_phases.cuh's sx_bin_row, in
// the same order, built with -fmad=false (a contracted FMA would move a
// sample on a bin edge).

#include <cuda_runtime.h>

#include "sxmc_phases.cuh"

// Dynamic shared memory: the block's count slots, then (in the last
// block) the norms; unsigned or float64 (hence the 8-byte alignment).
#define SX_HIST_SMEM(Acc, name)                          \
  extern __shared__ __align__(8) unsigned sx_hsmem[];    \
  Acc* name = reinterpret_cast<Acc*>(sx_hsmem)

// Shared-memory bytes the slots may take: a block stays under the 48 KB
// a launch gets without an opt-in, and four blocks fit an SM.
static const int kHistBudget = 36 * 1024;
// Slots per block at most: one per lane of a warp; and no more than
// kSlotCells (unsigned) or kSlotCellsW (float64) cells in all, beyond
// which more slots bought nothing on an H100 but clearing and flushing
// them (float64 adds, a compare-and-swap loop in shared memory, want
// more slots than counts).
static const int kMaxSlots = 32;
static const int kSlotCells = 2048;
static const int kSlotCellsW = 8192;
// Rows of a chunk per thread, a power of two: about 16 floats of what
// it loads (the fields it reads, and the weight) with one theta, bound
// by the bytes, at 3 blocks an SM (80 registers; at 4 blocks and 64,
// 16 floats spilled, and 8 took about 10% longer over 10M rows); 4 with
// lock-step chains, whose binnings of every row for every chain keep
// the SM busy meanwhile, at 4 blocks an SM.
__host__ __device__ constexpr int sx_hist_rows(int width, bool chains,
                                               bool w) {
  const int f = (chains ? 4 : 16) / (width + w);
  return f >= 16 ? 16 : f >= 8 ? 8 : f >= 4 ? 4 : f >= 2 ? 2 : 1;
}

// What one row's binning reads, in register slots: slot s < nload holds
// field s; the slots after them hold the second field of each resolution
// systematic past nload, one slot per field.
struct SxRead {
  int nread;                // slots
  int field[SX_MAXFIELDS];  // the sample field of each slot
  int xslot[SX_MAXSYST];    // the slot of systematic k's second field
};

static SxRead sx_read_plan(const SxSpec& sp) {
  SxRead rd = {};
  rd.nread = sp.nload;
  for (int s = 0; s < sp.nload; ++s) rd.field[s] = s;
  for (int k = 0; k < sp.nsyst; ++k) {
    if (!sx_reads_extra(sp.syst_type[k])) continue;
    const int e = sp.syst_extra[k];
    int s = e;
    if (e >= sp.nload) {
      for (s = sp.nload; s < rd.nread && rd.field[s] != e; ++s) {
      }
      if (s == rd.nread) rd.field[rd.nread++] = e;
    }
    rd.xslot[k] = s;
  }
  return rd;
}

// Register slots of the binning's form: 1, 2, 4 or 8.
static int sx_hist_width(const SxRead& rd) {
  return rd.nread <= 1 ? 1 : rd.nread == 2 ? 2 : rd.nread <= 4 ? 4 : 8;
}

// Words (of the accumulator's type) between two slots' copies: at least
// cells, and 1 mod 32.
__host__ __device__ __forceinline__ int sx_slot_stride(int cells) {
  return ((cells + 30) / 32) * 32 + 1;
}

// The flat bin ids of kN items, or -1 out of domain: item j is a row of
// segment seg (its slots in x[j], transformed in place) binned for
// chain c0 + j % kG.  The operations of sx_bin_row, in its order, one
// systematic at a time over every item, so that the spec's uniform
// guards run once per call.  A one-parameter systematic's p and 1 + p
// come from coef (chain c's at c * SX_MAXSYST); the others' parameters
// from par[c * pstride ...], read for chains below nchains only.
template <int kF, int kN, int kG>
__device__ __forceinline__ void sx_hist_bin(const SxSpec& sp,
                                            const SxRead& rd,
                                            float (&x)[kN][kF], int seg,
                                            int c0, int nchains,
                                            const float* __restrict__ par,
                                            int pstride, const float2* coef,
                                            int (&id)[kN]) {
  const float* cpar[kG];  // each chain's parameters
#pragma unroll
  for (int g = 0; g < kG; ++g)
    cpar[g] = par + (c0 + g < nchains ? c0 + g : nchains - 1) * pstride;
#pragma unroll
  for (int k = 0; k < SX_MAXSYST; ++k) {
    if (k >= sp.nsyst) break;
    if (!((sp.syst_mask[k] >> seg) & 1u)) continue;
    const int o = kF == 1 ? 0 : sp.syst_obs[k];
    float xo[kN], p[kN], q[kN];  // q = 1 + p
#pragma unroll
    for (int j = 0; j < kN; ++j) xo[j] = sx_pick(x[j], o);
    if (sp.syst_npow[k] == 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float2 cf = coef[(c0 + g) * SX_MAXSYST + k];
#pragma unroll
        for (int j = g; j < kN; j += kG) {
          p[j] = cf.x;
          q[j] = cf.y;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float pj = 0.0f;
        float xi = 1.0f;
#pragma unroll
        for (int t = 0; t < SX_MAXPOW; ++t) {
          if (t >= sp.syst_npow[k]) break;
          if (t > 0) xi = xi * xo[j];
          pj = pj + __ldg(&cpar[j % kG][sp.syst_par[k * SX_MAXPOW + t]]) * xi;
        }
        p[j] = pj;
        q[j] = 1.0f + pj;
      }
    }
    float nw[kN];
    switch (sp.syst_type[k]) {
      case SX_SHIFT:
#pragma unroll
        for (int j = 0; j < kN; ++j) nw[j] = xo[j] + p[j];
        break;
      case SX_SCALE:
#pragma unroll
        for (int j = 0; j < kN; ++j) nw[j] = xo[j] * q[j];
        break;
      case SX_CTSCALE:
#pragma unroll
        for (int j = 0; j < kN; ++j) nw[j] = 1.0f + (xo[j] - 1.0f) * q[j];
        break;
      default: {
        const int xs = rd.xslot[k];
#pragma unroll
        for (int j = 0; j < kN; ++j)
          nw[j] = xo[j] + p[j] * (xo[j] - sx_pick(x[j], xs));
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int a = 0; a < kF; ++a)
        if (a == o) x[j][a] = nw[j];
  }
  // The observables are the first nobs <= SX_MAXOBS slots.
  constexpr int kBin = kF < SX_MAXOBS ? kF : SX_MAXOBS;
#pragma unroll
  for (int j = 0; j < kN; ++j) id[j] = 0;
#pragma unroll
  for (int a = 0; a < kBin; ++a) {
    if (a >= sp.nobs) break;
    const float lower = sp.lower[a], upper = sp.upper[a];
    const float scale = sp.scale[a];
    const int top = sp.nbins[a] - 1, stride = sp.strides[a];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float v = x[j][a];
      if (!(v >= lower && v < upper)) {
        id[j] = -1;
      } else if (id[j] >= 0) {
        int ax = (int)floorf((v - lower) * scale);
        ax = min(max(ax, 0), top);
        id[j] += ax * stride;
      }
    }
  }
}

// Rows loaded together by one thread: kV = min(kRows, 4) consecutive
// rows of a field, one 4 * kV-byte load.  Row r of a thread's chunk is
// row c0 + (r / kV) * kV * 256 + kV * threadIdx.x + r % kV.
template <int kRows>
__device__ __forceinline__ unsigned sx_hist_row(unsigned c0, int r) {
  constexpr int kV = kRows < 4 ? kRows : 4;
  return c0 + (r / kV) * kV * SX_THREADS + kV * threadIdx.x + r % kV;
}

// Load a chunk: x[r] the slots of its row r (sx_hist_row), w[r] its
// weight (kW), zeros past row n.  A field whose rows start 4 * kV-byte
// aligned (bit s of aligned; bit kF: the weights) takes vector loads
// where all kV rows exist, the others 4-byte loads.  Rows are unsigned
// 32-bit (n < 2^31, so a chunk's rows never wrap).
template <int kF, int kRows, bool kW>
__device__ __forceinline__ void sx_hist_load(
    const SxRead& rd, const float* __restrict__ samples,
    const float* __restrict__ wrow, unsigned n, unsigned c0,
    unsigned aligned, float (&x)[kRows][kF], float (&w)[kRows]) {
  constexpr int kV = kRows < 4 ? kRows : 4;
#pragma unroll
  for (int q = 0; q < kRows / kV; ++q) {
    const unsigned i0 = sx_hist_row<kRows>(c0, q * kV);
    const bool all = i0 + kV <= n;
#pragma unroll
    for (int s = 0; s <= kF; ++s) {
      if (s == kF && !kW) break;
      const float* src = s == kF ? wrow + i0
                                 : samples + (long long)rd.field[s] * n + i0;
      float v[kV];
      if (s < kF && s >= rd.nread) {
#pragma unroll
        for (int e = 0; e < kV; ++e) v[e] = 0.0f;
      } else if (all && ((aligned >> s) & 1u)) {
        if constexpr (kV == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
        } else if constexpr (kV == 2) {
          const float2 t = *reinterpret_cast<const float2*>(src);
          v[0] = t.x, v[1] = t.y;
        } else {
          v[0] = *src;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) v[e] = i0 + e < n ? src[e] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        if (s < kF)
          x[q * kV + e][s] = v[e];
        else
          w[q * kV + e] = v[e];
      }
    }
  }
}

// Add one to the unsigned count at shared-memory address a where in
// holds: a predicated reduction, no branch around it.
__device__ __forceinline__ void sx_red_shared(unsigned a, bool in) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t"
      "@p red.shared.add.u32 [%0], 1;\n\t}"
      :
      : "r"(a), "r"((unsigned)in)
      : "memory");
}

// Read a cell of the accumulator and leave 0 in its place.
__device__ __forceinline__ unsigned sx_take(unsigned* a) {
  return atomicExch(a, 0u);
}
__device__ __forceinline__ double sx_take(double* a) {
  return __longlong_as_double(
      (long long)atomicExch(reinterpret_cast<unsigned long long*>(a), 0ull));
}

// The last block: the float32 bins (rows of total cells) and each row's
// norm, the sum of its bins (summed in s_norm, nrows entries), from the
// accumulator, which it leaves zeroed, as the ticket.  Loads kTake cells
// a lane before it uses one.
template <bool kW>
__device__ __forceinline__ void sx_hist_finish(int nrows, int total,
                                               SxAcc<kW>* acc,
                                               unsigned* ticket,
                                               float* __restrict__ out,
                                               SxAcc<kW>* s_norm) {
  using Acc = SxAcc<kW>;
  constexpr int kTake = 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cells = nrows * total;
  for (int t = tid; t < nrows; t += SX_THREADS) s_norm[t] = Acc(0);
  __syncthreads();
  // Warp-uniform: lane l of warp w takes cells base + u * 256 + l.
  for (int base = tid & ~31; base < cells; base += SX_THREADS * kTake) {
    Acc v[kTake];
#pragma unroll
    for (int u = 0; u < kTake; ++u) {
      const int t = base + u * SX_THREADS + lane;
      v[u] = t < cells ? sx_take(&acc[t]) : Acc(0);
    }
#pragma unroll
    for (int u = 0; u < kTake; ++u) {
      const int t = base + u * SX_THREADS + lane;
      if (t < cells) out[t] = (float)v[u];
      const int key = t < cells ? t / total : -1;
      const int key0 = __shfl_sync(0xffffffffu, key, 0);
      if (__all_sync(0xffffffffu, key == key0)) {
        if (key0 >= 0) {
          Acc s;
          if constexpr (kW) {
            s = sx_warp_sum(v[u]);
          } else {
            s = __reduce_add_sync(0xffffffffu, v[u]);
          }
          if (lane == 0 && s != Acc(0)) atomicAdd(&s_norm[key0], s);
        }
      } else if (v[u] != Acc(0)) {
        atomicAdd(&s_norm[key], v[u]);
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < nrows; t += SX_THREADS)
    out[cells + t] = (float)s_norm[t];
  if (tid == 0) *ticket = 0u;
}

// kF register slots a row, kChains lock-step chains (else one), kW
// weighted samples (their weight row after the nfields fields).  One
// theta: 3 blocks an SM, 80 registers a thread; lock-step chains 4 and
// 64 (sx_hist_rows).
template <int kF, bool kChains, bool kW>
__global__ void __launch_bounds__(SX_THREADS, kChains ? 4 : 3)
sx_hist_kernel(const SxSpec sp, const SxRead rd,
               const float* __restrict__ samples,
               const float* __restrict__ par, int nchains, int pstride,
               int nslot, SxAcc<kW>* acc, unsigned* ticket,
               float* __restrict__ out) {
  using Acc = SxAcc<kW>;
  constexpr int kRows = sx_hist_rows(kF, kChains, kW);
  constexpr int kChunk = kRows * SX_THREADS;
  // Chains binned together: 4, or 2 where the rows or the slots are
  // many (kRows 4 x 4 chains of one slot spilled 248 bytes).
  constexpr int kG = kChains ? (kF >= 8 || kRows >= 4 ? 2 : 4) : 1;
  constexpr int kN = kRows * kG;  // items binned together
  if (!kChains) nchains = 1;  // lets the compiler fold the chain loop away
  SX_HIST_SMEM(Acc, sh);
  __shared__ float2 s_coef[(kChains ? SX_MAXCHAINS : 1) * SX_MAXSYST];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int per = sp.ndyn * sp.total;  // one chain's histograms
  const int cells = nchains * per;
  const int stride = sx_slot_stride(cells);
  const unsigned n = sp.seg_off[sp.ndyn];
  const float* __restrict__ wrow = samples + (long long)sp.nfields * n;
  const unsigned step = gridDim.x * kChunk;

  // Which fields' rows start aligned for the vector loads.
  constexpr int kV = kRows < 4 ? kRows : 4;
  unsigned aligned = 0;
#pragma unroll
  for (int s = 0; s <= kF; ++s) {
    const float* f = s < kF ? samples + (long long)rd.field[s] * n : wrow;
    if (reinterpret_cast<unsigned long long>(f) % (4 * kV) == 0)
      aligned |= 1u << s;
  }

  // The first chunk's loads go out before the slots are cleared.
  long long c0 = (long long)blockIdx.x * kChunk;
  float x[kRows][kF];
  float w[kRows];
  sx_hist_load<kF, kRows, kW>(rd, samples, wrow, n, c0, aligned, x, w);
  for (int t = tid; t < nslot * stride; t += SX_THREADS) sh[t] = Acc(0);
  // p = 0 + theta * 1 and 1 + p of each chain's systematics, as the row
  // code computes them (used for the one-parameter ones).
  for (int t = tid; t < nchains * sp.nsyst; t += SX_THREADS) {
    const int c = t / sp.nsyst;
    const int k = t - c * sp.nsyst;
    float p = 0.0f;
    const float xi = 1.0f;
    p = p + par[c * pstride + sp.syst_par[k * SX_MAXPOW]] * xi;
    s_coef[c * SX_MAXSYST + k] = make_float2(p, 1.0f + p);
  }
  __syncthreads();

  // This thread's slot (shared-memory atomics), or the accumulator.
  Acc* mine = sh + (tid & (nslot - 1)) * stride;
  const unsigned mine_s = (unsigned)__cvta_generic_to_shared(mine);
  int seg = 0;
  for (; c0 < n; c0 += step) {
    float xn[kRows][kF];  // the next chunk, in flight while this one bins
    float wn[kRows];
    sx_hist_load<kF, kRows, kW>(rd, samples, wrow, n, c0 + step, aligned, xn,
                                wn);
    const unsigned c1 = c0 + kChunk;
    while ((unsigned)sp.seg_off[seg + 1] <= c0) ++seg;
    for (int d = seg; d < sp.ndyn && (unsigned)sp.seg_off[d] < c1; ++d) {
      const unsigned lo = max((unsigned)sp.seg_off[d], (unsigned)c0);
      const unsigned hi = min((unsigned)sp.seg_off[d + 1], c1);
      for (int cg = 0; cg < nchains; cg += kG) {
        int id[kN];
        if constexpr (kChains) {
          float xi[kN][kF];  // each row once per chain of the group
#pragma unroll
          for (int j = 0; j < kN; ++j)
#pragma unroll
            for (int s = 0; s < kF; ++s) xi[j][s] = x[j / kG][s];
          sx_hist_bin<kF, kN, kG>(sp, rd, xi, d, cg, nchains, par, pstride,
                                  s_coef, id);
        } else {
          // One theta bins the rows in place; the rare chunk that
          // straddles a segment boundary loads them again for the next.
          if (d != seg)
            sx_hist_load<kF, kRows, kW>(rd, samples, wrow, n, c0, aligned, x,
                                        w);
          sx_hist_bin<kF, kN, 1>(sp, rd, x, d, 0, 1, par, pstride, s_coef,
                                 id);
        }
        // The rows of a chunk wholly inside segment d need no check.
        const bool whole = lo == (unsigned)c0 && hi == c1;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const int r = j / kG;
          const int c = cg + j % kG;
          const unsigned i = sx_hist_row<kRows>(c0, r);
          const bool in = (whole || (i >= lo && i < hi)) &&
                          (kG == 1 || c < nchains) && id[j] >= 0;
          const int cell = (c * sp.ndyn + d) * sp.total + id[j];
          if constexpr (kW) {
            if (in) {
              if (nslot)
                atomicAdd(&mine[cell], (double)w[r]);
              else
                atomicAdd(&acc[cell], (double)w[r]);
            }
          } else if (nslot) {
            sx_red_shared(mine_s + 4u * cell, in);
          } else if (in) {
            atomicAdd(&acc[cell], 1u);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int s = 0; s < kF; ++s) x[r][s] = xn[r][s];
      if constexpr (kW) w[r] = wn[r];
    }
  }
  __syncthreads();
  if (nslot) {
    for (int t = tid; t < cells; t += SX_THREADS) {
      Acc v = 0;
      for (int s = 0; s < nslot; ++s) v += sh[s * stride + t];
      if (v != Acc(0)) atomicAdd(&acc[t], v);
    }
  }
  // Every block's counts are in the accumulator before the last block
  // takes its ticket.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sx_hist_finish<kW>(nchains * sp.ndyn, sp.total, acc, ticket, out, sh);
}

template <int kF>
static const void* sx_hist_fn_f(bool chains, bool w) {
  if (w)
    return chains ? (const void*)sx_hist_kernel<kF, true, true>
                  : (const void*)sx_hist_kernel<kF, false, true>;
  return chains ? (const void*)sx_hist_kernel<kF, true, false>
                : (const void*)sx_hist_kernel<kF, false, false>;
}

static const void* sx_hist_fn(int width, bool chains, bool w) {
  switch (width) {
    case 1: return sx_hist_fn_f<1>(chains, w);
    case 2: return sx_hist_fn_f<2>(chains, w);
    case 4: return sx_hist_fn_f<4>(chains, w);
    default: return sx_hist_fn_f<8>(chains, w);
  }
}

static int sx_hist_cell_bytes(bool w) { return w ? 8 : 4; }

// Slots that fit the budget: a power of two up to kMaxSlots, or 0.
static int sx_hist_fit(int cells, bool w) {
  const long long one = (long long)sx_slot_stride(cells) *
                        sx_hist_cell_bytes(w);
  for (int s = kMaxSlots; s >= 1; s >>= 1)
    if (s * one <= kHistBudget) return s;
  return 0;
}

// The rule's slots: those that fit, at most kSlotCells(W) / cells.
static int sx_hist_slots(int cells, bool w) {
  int s = sx_hist_fit(cells, w);
  while (s > 1 && s * cells > (w ? kSlotCellsW : kSlotCells)) s >>= 1;
  return s;
}

// Dynamic shared memory of a launch: the slots, or the last block's
// norms if they take more.
static int sx_hist_smem(int cells, int nrows, int nslot, bool w) {
  const long long slots = (long long)nslot * sx_slot_stride(cells);
  return (int)((slots > nrows ? slots : nrows) * sx_hist_cell_bytes(w));
}

extern "C" {

// B1's grid and slots for this layout and chain count: the blocks
// (sx_hist_kernel's occupancy at the slots' shared memory on every SM,
// no more than the chunks) and the slots (sx_hist_slots).  The wrapper
// asks once per layout, chain count and device.
int sx_hist_grid(const SxSpec* sp, int nchains, int weighted, int* nblocks,
                 int* nslot) {
  if (nchains < 1 || nchains > SX_MAXCHAINS) return cudaErrorInvalidValue;
  const bool w = weighted != 0;
  const SxRead rd = sx_read_plan(*sp);
  const int width = sx_hist_width(rd);
  const int cells = nchains * sp->ndyn * sp->total;
  const bool chains = nchains > 1;
  const int slots = sx_hist_slots(cells, w);
  const int smem = sx_hist_smem(cells, nchains * sp->ndyn, slots, w);
  int dev = 0, nsm = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, sx_hist_fn(width, chains, w), SX_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  // As many blocks as fit on the card at once, or as there are chunks.
  const long long chunk =
      (long long)sx_hist_rows(width, chains, w) * SX_THREADS;
  const long long n = sp->seg_off[sp->ndyn];
  const long long chunks = n > 0 ? (n + chunk - 1) / chunk : 1;
  const long long cap = (long long)nsm * occ;
  *nblocks = (int)(chunks < cap ? chunks : cap);
  *nslot = slots;
  return cudaSuccess;
}

// B1: par holds nchains parameter vectors pstride apart; weighted samples
// carry their weight row after the nfields fields.  nblocks and nslot as
// sx_hist_grid gives them (nslot: 0 or a power of two whose slots fit
// the budget).  acc holds at least nchains * ndyn * total unsigned ints
// (float64 when weighted) and ticket one unsigned int, all zero, and
// both are left zero; out receives nchains * (ndyn * total + ndyn)
// float32: the (nchains, ndyn, total) counts, then the (nchains, ndyn)
// in-domain counts (weight sums when weighted).  One kernel launch.
int sx_histogram(const SxSpec* sp, int nchains, int weighted,
                 const float* samples, const float* par, int pstride,
                 int nblocks, int nslot, void* acc, unsigned* ticket,
                 float* out, void* stream) {
  const bool w = weighted != 0;
  const int cells = nchains * sp->ndyn * sp->total;
  const SxRead rd = sx_read_plan(*sp);
  const int width = sx_hist_width(rd);
  const bool chains = nchains > 1;
  if (nchains < 1 || nchains > SX_MAXCHAINS || pstride < 0 ||
      pstride > SX_MAXPAR || nblocks < 1 || nslot < 0 ||
      nslot > kMaxSlots || (nslot & (nslot - 1)) != 0 ||
      nslot > sx_hist_fit(cells, w))
    return cudaErrorInvalidValue;
  const int smem = sx_hist_smem(cells, nchains * sp->ndyn, nslot, w);
  const void* fn = sx_hist_fn(width, chains, w);
  SxSpec spv = *sp;
  SxRead rdv = rd;
  void* args[] = {(void*)&spv,     (void*)&rdv,    (void*)&samples,
                  (void*)&par,     (void*)&nchains, (void*)&pstride,
                  (void*)&nslot,   (void*)&acc,    (void*)&ticket,
                  (void*)&out};
  cudaError_t err = cudaLaunchKernel(fn, dim3(nblocks), dim3(SX_THREADS),
                                     args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
