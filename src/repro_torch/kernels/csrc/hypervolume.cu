// Monte-Carlo hypervolume counting kernels for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hypervolume.py::mc_hv_kernel, the Pallas TPU
// kernel that _mc_hv_padded launches through pl.pallas_call.
//
// Computes, for points P [n, m] and samples S [s, m] (float32, loss
// orientation: every objective minimized), with dom(j, i) = all_k P[i, k] <=
// S[j, k] (ties count; a NaN coordinate compares false, so a NaN point
// dominates nothing):
//   total   = #samples with at least one dominator,
//   excl[i] = #samples whose only dominator is point i.
// The hypervolume estimator scales both by box volume / s.
//
// Two entry points share one counting body (count_tile):
// * mc_hv_counts_launch: one point set against samples given as float32;
// * mc_hv_counts_sets_launch: G point sets in one launch, the greedy
//   hypervolume subset selection's whole step.  Each set g has its own box
//   [lo_g, lo_g + range_g] and its samples are made on the card from one
//   shared draw u [s, m] of float64 uniforms in [0, 1):
//     S_g[j, k] = float32(lo_g[k] + range_g[k] * u[j, k]),
//   a float64 product and a float64 sum, each rounded once, then one
//   rounding to float32.  That is how numpy's RandomState.uniform(lo, ref)
//   builds its samples (lo + (ref - lo) * u, range computed on the host)
//   and then how the estimator rounded them to float32 on the host, so the
//   counts are those of the per-call path, bit for bit.  The intrinsics keep
//   nvcc from contracting the two operations into one FMA.
//
// Design.  The TPU kernel keeps the whole point set in VMEM, walks sample
// tiles along a sequential grid axis and adds each tile's float counts into
// outputs that grid step 0 zeroes.  CUDA blocks run in no order, so a literal
// copy would race on those outputs.  Here one thread owns one sample, holds
// its coordinates in registers and walks the points, which are staged
// through shared memory in tiles of kTileFloats floats (n x m x 4 bytes is
// 128 KB at n = 4096, m = 8, so one tile cannot be assumed to hold them
// all).  A thread needs only to know whether it has 0, 1 or >= 2 dominators
// and which one when it has one, so it stops at the second dominator, and
// the block stops staging tiles once all of its samples have stopped.
// Counts are integers: per block in shared memory, then one atomicAdd per
// nonzero counter into global int32 outputs.  Integer adds commute, so the
// result is the same in any block order, and exact; the wrapper converts to
// float32 (exact below 2^24, as the reference's float counts are).  n and s
// are run-time arguments, so neither needs the reference's +-1e30 padding.
// The batched launch is a 2-D grid, sample tiles x sets.  A thread keeps
// up to 8 sample coordinates in registers and reads or remakes the rest:
// with 16 the kernels took 64 registers a thread (4 blocks an SM) and
// spilled, with 8 they take 40-48, and a greedy step of 143 sets of 24
// points took 0.096 ms of the card's time instead of 0.18 (PERF.md).
//
// Bound on this card.  The inputs are (n + s) x m x 4 bytes, read once; the
// work is up to s x n x m compares, fewer when samples meet two dominators
// early.  At the estimator's shapes (n <= a few dozen points, s = 8192) the
// data is a few hundred KB and the compares a few million, so one launch
// takes microseconds and launch latency bounds it; at large n the FP32
// compare rate does.  The greedy subset selection evaluates dozens of such
// sets a step: one launch a step leaves the launch's cost to the whole step
// and the host draws nothing.  A warp's threads read the same staged point
// at once, a shared-memory broadcast with no bank conflict.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // samples per block, one per thread
constexpr int kTileFloats = 4096;  // staged point coordinates per tile (16 KB)
constexpr int kMaxRegM = 8;        // sample coordinates held in registers
constexpr int kHist = 4096;        // per-block exclusive counters (16 KB)

// Samples given as float32 rows.
struct RowSamples {
  const float* smp;
  int m;
  __device__ float operator()(int j, int k) const {
    return smp[static_cast<long long>(j) * m + k];
  }
};

// Samples made from the shared draw: float32(lo + range * u), in float64.
struct BoxSamples {
  const double* lo;
  const double* range;
  const double* u;
  int m;
  __device__ float operator()(int j, int k) const {
    const double x = __dadd_rn(lo[k], __dmul_rn(range[k], u[static_cast<long long>(j) * m + k]));
    return __double2float_rn(x);
  }
};

// The counts of one block's kThreads samples, starting at sample j0, against
// the n points at pts, added into excl [n] and total [1].
template <typename Samples>
__device__ __forceinline__ void count_tile(const float* __restrict__ pts, int n, int m,
                                           const Samples& sample, int s, int j0,
                                           int* __restrict__ excl, int* __restrict__ total) {
  __shared__ float s_pts[kTileFloats];
  __shared__ int s_excl[kHist];
  __shared__ int s_total;
  const bool hist = n <= kHist;  // uniform across the grid
  if (hist) {
    for (int p = threadIdx.x; p < n; p += kThreads) s_excl[p] = 0;
  }
  if (threadIdx.x == 0) s_total = 0;
  const int j = j0 + threadIdx.x;
  const bool active = j < s;
  float sv[kMaxRegM];
#pragma unroll
  for (int k = 0; k < kMaxRegM; ++k) sv[k] = (active && k < m) ? sample(j, k) : 0.f;
  int cnt = active ? 0 : 2;  // threads past the ragged edge start "done"
  int last = -1;
  const int tile_n = kTileFloats / m;  // points per tile (the wrappers keep m <= kTileFloats)
  for (int base = 0; base < n; base += tile_n) {
    const int tn = min(tile_n, n - base);
    const float* src = pts + static_cast<long long>(base) * m;
    for (int q = threadIdx.x; q < tn * m; q += kThreads) s_pts[q] = src[q];
    __syncthreads();
    if (cnt < 2) {
      for (int p = 0; p < tn; ++p) {
        const float* row = s_pts + p * m;
        bool dom = true;
#pragma unroll
        for (int k = 0; k < kMaxRegM; ++k) {
          if (k < m) dom &= row[k] <= sv[k];
        }
        for (int k = kMaxRegM; k < m; ++k) dom &= row[k] <= sample(j, k);
        if (dom) {
          last = base + p;
          if (++cnt == 2) break;
        }
      }
    }
    // a barrier too: nobody restages s_pts while a thread still reads it
    if (__syncthreads_and(cnt >= 2)) break;
  }
  if (active && cnt >= 1) atomicAdd(&s_total, 1);
  if (active && cnt == 1) {
    if (hist) {
      atomicAdd(&s_excl[last], 1);
    } else {
      atomicAdd(&excl[last], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_total > 0) atomicAdd(total, s_total);
  if (hist) {
    for (int p = threadIdx.x; p < n; p += kThreads) {
      const int c = s_excl[p];
      if (c > 0) atomicAdd(&excl[p], c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mc_hv_counts_kernel(const float* __restrict__ pts, int n, const float* __restrict__ smp, int s,
                    int m, int* __restrict__ excl, int* __restrict__ total) {
  count_tile(pts, n, m, RowSamples{smp, m}, s, blockIdx.x * kThreads, excl, total);
}

// blockIdx.y is the set: points pts[off[g] .. off[g + 1]), counts into
// excl[off[g] ..) and total[g].
__global__ void __launch_bounds__(kThreads)
mc_hv_counts_sets_kernel(const float* __restrict__ pts, const int* __restrict__ off,
                         const double* __restrict__ lo, const double* __restrict__ range,
                         const double* __restrict__ u, int s, int m, int* __restrict__ excl,
                         int* __restrict__ total) {
  const int g = blockIdx.y;
  const int p0 = off[g];
  const int n = off[g + 1] - p0;
  if (n <= 0) return;  // uniform across the block
  const BoxSamples sample{lo + static_cast<long long>(g) * m,
                          range + static_cast<long long>(g) * m, u, m};
  count_tile(pts + static_cast<long long>(p0) * m, n, m, sample, s, blockIdx.x * kThreads,
             excl + p0, total + g);
}

// The samples of each set as the counting kernel makes them: out [G, s, m].
__global__ void __launch_bounds__(kThreads)
mc_hv_samples_kernel(const double* __restrict__ lo, const double* __restrict__ range,
                     const double* __restrict__ u, int s, int m, float* __restrict__ out) {
  const int g = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= s) return;
  const BoxSamples sample{lo + static_cast<long long>(g) * m,
                          range + static_cast<long long>(g) * m, u, m};
  float* row = out + (static_cast<long long>(g) * s + j) * m;
  for (int k = 0; k < m; ++k) row[k] = sample(j, k);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success).  `pts` [n, m] and `smp` [s, m] are row-major float32 device
// pointers; `excl` [n] and `total` [1] are int32 device pointers that the
// caller zeroes.  The caller guarantees n, s >= 1 and 1 <= m <= 4096.
extern "C" int mc_hv_counts_launch(const float* pts, int n, const float* smp, int s,
                                   int m, int* excl, int* total, void* stream) {
  const int blocks = (s + kThreads - 1) / kThreads;
  mc_hv_counts_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, n, smp, s, m, excl, total);
  return static_cast<int>(cudaGetLastError());
}

// The G sets in one launch on `stream`; returns cudaGetLastError() as an
// int.  `pts` [off[G], m] float32 row-major (set g's rows off[g] ..
// off[g + 1]); `off` [G + 1] int32; `lo` and `range` [G, m] float64; `u`
// [s, m] float64; `excl` [off[G]] and `total` [G] int32, zeroed by the
// caller.  The caller guarantees G, s >= 1, G <= 65535 and 1 <= m <= 4096.
extern "C" int mc_hv_counts_sets_launch(const float* pts, const int* off, const double* lo,
                                        const double* range, const double* u, int G, int s,
                                        int m, int* excl, int* total, void* stream) {
  const dim3 grid((s + kThreads - 1) / kThreads, G);
  mc_hv_counts_sets_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, off, lo, range, u, s, m, excl, total);
  return static_cast<int>(cudaGetLastError());
}

// The samples mc_hv_counts_sets_launch makes, written to `out` [G, s, m]
// float32 (for checks); same arguments and guarantees.
extern "C" int mc_hv_samples_launch(const double* lo, const double* range, const double* u,
                                    int G, int s, int m, float* out, void* stream) {
  const dim3 grid((s + kThreads - 1) / kThreads, G);
  mc_hv_samples_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, range, u, s, m, out);
  return static_cast<int>(cudaGetLastError());
}
