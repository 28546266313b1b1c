// Monte-Carlo hypervolume counting kernel for Hopper (sm_90a).
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
//
// Bound on this card.  The inputs are (n + s) x m x 4 bytes, read once; the
// work is up to s x n x m compares, fewer when samples meet two dominators
// early.  At the estimator's shapes (n <= a few dozen points, s = 8192) the
// data is a few hundred KB and the compares a few million, so one launch
// takes microseconds and launch latency bounds it; at large n the FP32
// compare rate does.  A warp's threads read the same staged point at once,
// a shared-memory broadcast with no bank conflict.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // samples per block, one per thread
constexpr int kTileFloats = 4096;  // staged point coordinates per tile (16 KB)
constexpr int kMaxRegM = 16;       // sample coordinates held in registers
constexpr int kHist = 4096;        // per-block exclusive counters (16 KB)

__global__ void __launch_bounds__(kThreads)
mc_hv_counts_kernel(const float* __restrict__ pts, int n,
                    const float* __restrict__ smp, int s, int m,
                    int* __restrict__ excl, int* __restrict__ total) {
  __shared__ float s_pts[kTileFloats];
  __shared__ int s_excl[kHist];
  __shared__ int s_total;

  const bool hist = n <= kHist;  // uniform across the grid
  if (hist) {
    for (int p = threadIdx.x; p < n; p += kThreads) s_excl[p] = 0;
  }
  if (threadIdx.x == 0) s_total = 0;

  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool active = j < s;
  const float* row_s = smp + static_cast<long long>(j) * m;
  float sv[kMaxRegM];
#pragma unroll
  for (int k = 0; k < kMaxRegM; ++k) sv[k] = (active && k < m) ? row_s[k] : 0.f;

  int cnt = active ? 0 : 2;  // threads past the ragged edge start "done"
  int last = -1;
  const int tile_n = kTileFloats / m;  // points per tile (the wrapper keeps m <= kTileFloats)

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
        for (int k = kMaxRegM; k < m; ++k) dom &= row[k] <= row_s[k];
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
