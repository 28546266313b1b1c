// Fused cross-entropy forward kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/crossentropy.py::crossentropy_kernel, the Pallas
// TPU kernel that fused_crossentropy launches through pl.pallas_call.
//
// Computes, for token rows x [T, D] (float32 or bfloat16), an output matrix
// W [D, V] (float32 or bfloat16, any element strides) and labels [T] (int32
// or int64), per row t:
//   z[t, v]  = x[t] . round_x(W[:, v]) in float32 (round_x: W rounded to x's
//              type as it is loaded, so a bfloat16 x meets a bfloat16 W, as
//              the reference's w_out.astype(x.dtype) gives it), then
//              cap * tanh(z / cap) when cap != 0;
//   lse[t]   = m + log(max(l, 1e-30)), the online logsumexp over v < V;
//   nll[t]   = lse[t] - z[t, labels[t]], with no label logit when the label
//              lies outside [0, V).
// The [T, V] logits never reach device memory.
//
// Two kernels, chosen by x's type (a fixed rule, not a fallback): a bfloat16
// x, the model's compute type in training and tuning, always takes the
// tensor-core kernel; a float32 x takes the CUDA-core kernel, whose float32
// products the float32 parity checks rely on (TF32 products would not hold
// them).
//
// Design, both kernels.  The TPU kernel walks a (row block, vocabulary block)
// grid with the vocabulary innermost and carries (m, l, label logit) in VMEM
// scratch from one vocabulary step to the next.  CUDA blocks run in no order,
// so here one block owns 128 token rows and loops over a contiguous range of
// 128-column vocabulary tiles itself, keeping per-row (m, l, label logit) in
// registers.  At gemma2's training shape (T = 8192) 64 row blocks would leave
// half the 132 SMs idle, so the vocabulary is split across blockIdx.y: each
// block writes its range's partial (m, l, label logit), and a second small
// kernel combines the partials of a row in order, one thread per row (no
// atomics, so the result does not depend on block order).  This combine pass
// replaces the TPU's sequential +=.  blockIdx.x runs over the row blocks, so
// the blocks resident at one time share a vocabulary split and walk the same
// W tiles together: each W tile comes from device memory about once and from
// L2 after that.  Columns past V and rows past T are masked in the kernel:
// the edges need no padded copies.
//
// bfloat16 x: tensor cores (crossentropy_tc_kernel; mma.sync and cp.async
// from tensor_core.cuh).  W arrives as a bfloat16, K-major operand ([V, D]
// rows): the wrapper casts it once a call, the reference's own
// w_out.astype(x.dtype); the tied head (the transposed view of a [V, D]
// embedding) keeps its layout, an untied [D, V] head is transposed as it is
// cast.  A block of 4 warps owns 128 rows, 32 a warp, and each warp the full
// 128 columns of a tile, so a row's (m, l) never leaves its quad of lanes.
// The block's (vocabulary tile, 64-deep slice of D) pairs form one stream
// fed through a three-stage cp.async ring, the next tile's first slices in
// flight while a tile's last slice and its epilogue run.  Per slice, each
// warp runs its 32 x 128 x 64 product on the tensor cores (mma.sync.m16n8k16,
// bf16 fragments from ldmatrix, float32 accumulators, 128 a thread).  After
// a tile's last slice, the epilogue works on the accumulator fragment: the
// softcap (tanhf, no fast math; a separate instance of the kernel without
// it), the label pick, the edge mask (on the last tile only), and the
// online (m, l) update in base 2 (exp2f, no fast math) over the thread's
// own columns, as the flash-attention softmax does.  After the last tile the four lanes of a row
// combine their partials.  x's rows must be 16-byte aligned (row stride a
// multiple of 8 elements), which the wrapper checks; the cast pads W's rows
// when they are not.
//
// float32 x: CUDA cores (crossentropy_kernel, the port's first kernel).  A
// block of 256 threads; per tile:
//   1. the product runs as a classic tiled SGEMM: 16-deep slices of x and W
//      are staged in shared memory (16 KB), and each thread accumulates an
//      8 x 8 register block of logits (rows ty*8 + i, columns tx + 16*j) with
//      float32 FMAs on the CUDA cores.  A whole [128, D] row tile is never
//      staged (it would not fit at D = 2048 or 3584);
//   2. the softcap (tanhf, no fast math), the edge masks, the label pick, and
//      an online (m, l) update per row over the thread's own columns.
// After the last tile the 16 lanes that share a row combine their (m, l,
// label logit) with warp shuffles.  W is read through its element strides,
// so the tied head is read in place and rounded to x's type as it loads.
//
// Bound on this card.  2 T D V operations against (T D + D V) input bytes: at
// tinyllama-1.1b's training shape (T = 16384, D = 2048, V = 32000) 2.15e12
// FLOPs, 2.17 ms at the bf16 tensor-core rate, against 0.06 ms of bytes, so
// the operations bound it.  The tensor-core kernel runs its products there,
// through mma.sync, which reaches a fraction of the rate wgmma reaches (with
// TMA feeding a ring and warp-specialised producers); the 128 x 128 block
// tile re-reads x and W from L2 at 64 FLOPs a byte, and the epilogue's
// softcap and exp run between tiles.  The float32 kernel runs on the CUDA
// cores in float32 (about six FMAs per shared-memory load instruction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 128;               // token rows a block
constexpr int kBV = 128;               // vocabulary columns a tile
constexpr int kBK = 16;                // depth of a staged slice
constexpr int kLanes = 16;             // tx = threadIdx.x % 16: the lanes of a row
constexpr int kTM = kBT / (kThreads / kLanes);  // 8 rows a thread
constexpr int kTN = kBV / kLanes;      // 8 columns a thread
constexpr int kPad = 4;                // keeps float4 rows 16-byte aligned
constexpr float kMasked = -1e30f;
constexpr int kTargetBlocks = 2 * 132; // two blocks for each SM of an H100

struct Params {
  const void* x;
  const void* w;
  const void* labels;
  float* part;  // [3][nsplit][T]: m, l, label logit
  long long x_st, x_sd;  // element strides of x (row, depth)
  long long w_sd, w_sv;  // element strides of W (depth, vocabulary)
  int T, D, V;
  int tiles_per_split, nsplit;
  int labels64;
  float softcap;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// W's value as x's type sees it (the CUDA-core kernel is instantiated for a
// float32 x alone: a bfloat16 x takes the tensor-core kernel).
template <typename TX>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) crossentropy_kernel(const Params p) {
  __shared__ __align__(16) float xs[kBK][kBT + kPad];
  __shared__ __align__(16) float ws[kBK][kBV + kPad];

  const TX* x = static_cast<const TX*>(p.x);
  const TW* w = static_cast<const TW*>(p.w);
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid % kLanes;
  const int row0 = blockIdx.x * kBT;
  const int n_tiles = (p.V + kBV - 1) / kBV;
  const int tile_begin = blockIdx.y * p.tiles_per_split;
  const int tile_end = min(tile_begin + p.tiles_per_split, n_tiles);

  float m[kTM], l[kTM], ll[kTM];
  int lab[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
    ll[i] = 0.f;
    const int t = row0 + ty * kTM + i;
    long long y = -1;
    if (t < p.T) {
      y = p.labels64 ? static_cast<const long long*>(p.labels)[t]
                     : static_cast<long long>(static_cast<const int*>(p.labels)[t]);
    }
    lab[i] = (y >= 0 && y < p.V) ? static_cast<int>(y) : -1;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int v0 = tile * kBV;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < p.D; k0 += kBK) {
      __syncthreads();  // the previous slice has been read
      // x slice: depth fastest, as x's rows are laid out
      for (int e = tid; e < kBT * kBK; e += kThreads) {
        const int r = e / kBK, k = e % kBK;
        const int t = row0 + r, d = k0 + k;
        xs[k][r] = (t < p.T && d < p.D) ? to_f32(x[t * p.x_st + d * p.x_sd]) : 0.f;
      }
      // W slice: walk along whichever axis W is contiguous in
      if (p.w_sv == 1) {
        for (int e = tid; e < kBK * kBV; e += kThreads) {
          const int k = e / kBV, c = e % kBV;
          const int d = k0 + k, v = v0 + c;
          ws[k][c] = (d < p.D && v < p.V) ? round_to<TX>(to_f32(w[d * p.w_sd + v * p.w_sv])) : 0.f;
        }
      } else {
        for (int e = tid; e < kBK * kBV; e += kThreads) {
          const int c = e / kBK, k = e % kBK;
          const int d = k0 + k, v = v0 + c;
          ws[k][c] = (d < p.D && v < p.V) ? round_to<TX>(to_f32(w[d * p.w_sd + v * p.w_sv])) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * kTM]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * kTM + 4]);
        const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = ws[k][tx + kLanes * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // softcap, label pick and the online (m, l) update over this tile
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float tmax = kMasked;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int v = v0 + tx + kLanes * j;
        float z = acc[i][j];
        if (p.softcap != 0.f) z = p.softcap * tanhf(z / p.softcap);
        acc[i][j] = z;
        if (v < p.V) {
          tmax = fmaxf(tmax, z);
          if (v == lab[i]) ll[i] += z;
        }
      }
      if (tmax == kMasked) continue;  // none of this thread's columns is valid
      const float m_new = fmaxf(m[i], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (v0 + tx + kLanes * j < p.V) sum += expf(acc[i][j] - m_new);
      }
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  // combine the 16 lanes of each row (lanes ty*16 .. ty*16 + 15 of one warp)
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float ll_o = __shfl_xor_sync(0xffffffffu, ll[i], off);
      const float m_new = fmaxf(m[i], m_o);
      l[i] = l[i] * expf(m[i] - m_new) + l_o * expf(m_o - m_new);
      ll[i] += ll_o;
      m[i] = m_new;
    }
    const int t = row0 + ty * kTM + i;
    if (tx == 0 && t < p.T) {
      const long long base = static_cast<long long>(blockIdx.y) * p.T + t;
      const long long plane = static_cast<long long>(p.nsplit) * p.T;
      p.part[base] = m[i];
      p.part[plane + base] = l[i];
      p.part[2 * plane + base] = ll[i];
    }
  }
}

// One thread per row: fold the vocabulary splits' partials in split order.
__global__ void crossentropy_combine(const float* part, int nsplit, int T, float* nll,
                                     float* lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const long long plane = static_cast<long long>(nsplit) * T;
  float m = kMasked;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part[static_cast<long long>(s) * T + t]);
  float l = 0.f, ll = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long at = static_cast<long long>(s) * T + t;
    l += part[plane + at] * expf(part[at] - m);
    ll += part[2 * plane + at];
  }
  const float out = m + logf(fmaxf(l, 1e-30f));
  lse[t] = out;
  nll[t] = out - ll;
}

int row_blocks(int T) { return (T + kBT - 1) / kBT; }

// (vocabulary splits, tiles a split) for T rows and V columns: enough blocks
// for two on every SM, no split empty.
void splits(int T, int V, int* nsplit, int* tiles_per_split) {
  const int n_tiles = (V + kBV - 1) / kBV;
  const int rows = row_blocks(T);
  int want = (kTargetBlocks + rows - 1) / rows;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  *tiles_per_split = (n_tiles + want - 1) / want;
  *nsplit = (n_tiles + *tiles_per_split - 1) / *tiles_per_split;
}

template <typename TX, typename TW>
cudaError_t launch(const Params& p, float* nll, float* lse, cudaStream_t stream) {
  const dim3 grid(row_blocks(p.T), p.nsplit);
  crossentropy_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kCombineThreads = 256;
  crossentropy_combine<<<(p.T + kCombineThreads - 1) / kCombineThreads, kCombineThreads, 0,
                         stream>>>(p.part, p.nsplit, p.T, nll, lse);
  return cudaGetLastError();
}


// -- bfloat16 x: tensor cores -------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps of 32 rows x 128 columns
constexpr int kTcBT = 128;       // token rows a block
constexpr int kTcBV = 128;       // vocabulary columns a tile
constexpr int kTcBK = 64;        // depth of a staged slice
constexpr int kTcStages = 3;
constexpr int kTcLD = kTcBK + 8;  // shared row stride of both tiles (tensor_core.cuh)
constexpr int kTcStageElems = (kTcBT + kTcBV) * kTcLD;  // x's [BT][BK] and W's [BV][BK]
constexpr size_t kTcSmemBytes = sizeof(__nv_bfloat16) * kTcStages * kTcStageElems;
constexpr int kTcTargetBlocks = 2 * 132;  // two blocks (8 warps) on each SM of an H100

struct TcParams {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;  // K-major: element (d, v) at w[v * w_ld + d]
  const void* labels;
  float* part;     // [3][nsplit][T]: m, l, label logit
  long long x_st;  // x's row stride; its depth is contiguous
  long long w_ld;
  int T, D, V;
  int tiles_per_split, nsplit;
  int labels64;
  float softcap;
};

// Stages x's [kTcBT, kTcBK] rows at (row0, k0) and W's [kTcBV, kTcBK] tile at
// (v0, k0) into one stage of the ring.
__device__ __forceinline__ void tc_load_slice(const TcParams& p, tc::bf16* stage, int row0,
                                              int v0, int k0) {
  tc::load_tile<kTcBT, kTcBK, kTcLD, kTcThreads>(stage, p.x + row0 * p.x_st + k0, p.x_st,
                                                 p.T - row0, p.D - k0);
  tc::load_tile<kTcBV, kTcBK, kTcLD, kTcThreads>(stage + kTcBT * kTcLD, p.w + v0 * p.w_ld + k0,
                                                 p.w_ld, p.V - v0, p.D - k0);
}

template <bool SOFTCAP>
__global__ void __launch_bounds__(kTcThreads) crossentropy_tc_kernel(const TcParams p) {
  using tc::bf16;
  extern __shared__ uint4 tc_smem[];
  bf16* smem = reinterpret_cast<bf16*>(tc_smem);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * kTcBT;
  const int n_tiles = (p.V + kTcBV - 1) / kTcBV;
  const int tile_begin = blockIdx.y * p.tiles_per_split;
  const int tile_end = min(tile_begin + p.tiles_per_split, n_tiles);
  const int nk = (p.D + kTcBK - 1) / kTcBK;
  const int total = (tile_end - tile_begin) * nk;  // (tile, slice) pairs of this block

  // this thread's rows: warp * 32 + mi * 16 + g + 8 * hh
  float m[2][2], l[2][2], ll[2][2];
  int lab[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mi][hh] = tc::kMasked;
      l[mi][hh] = 0.f;
      ll[mi][hh] = 0.f;
      const int row = row0 + warp * 32 + mi * 16 + g + 8 * hh;
      long long y = -1;
      if (row < p.T) {
        y = p.labels64 ? static_cast<const long long*>(p.labels)[row]
                       : static_cast<long long>(static_cast<const int*>(p.labels)[row]);
      }
      lab[mi][hh] = (y >= 0 && y < p.V) ? static_cast<int>(y) : -1;
    }
  }

  // slice i of the stream: vocabulary tile tile_begin + i / nk, depth (i % nk) kTcBK,
  // into stage i % kTcStages
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < total) {
      tc_load_slice(p, smem + s * kTcStageElems, row0, (tile_begin + s / nk) * kTcBV,
                    (s % nk) * kTcBK);
    }
    tc::cp_async_commit();
  }

  const int a_off = tc::a_offset<kTcLD>(lane);
  const int b_off = tc::b_offset<kTcLD>(lane);
  float acc[2][16][4];
  for (int i = 0; i < total; ++i) {
    tc::cp_async_wait<kTcStages - 2>();
    __syncthreads();  // slice i has landed; every warp is done with slice i - 1's stage
    const int next = i + kTcStages - 1;
    if (next < total) {
      tc_load_slice(p, smem + (next % kTcStages) * kTcStageElems, row0,
                    (tile_begin + next / nk) * kTcBV, (next % nk) * kTcBK);
    }
    tc::cp_async_commit();
    const int slice = i % nk;
    if (slice == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 16; ++n)
          acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;
    }
    const bf16* xs = smem + (i % kTcStages) * kTcStageElems;
    const bf16* ws = xs + kTcBT * kTcLD;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        tc::ldmatrix_x4(a[mi], xs + (warp * 32 + mi * 16) * kTcLD + a_off + kk * 16);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {  // 16 vocabulary columns at a time
        uint32_t b[4];
        tc::ldmatrix_x4(b, ws + n * 16 * kTcLD + b_off + kk * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          tc::mma_16816(acc[mi][2 * n], a[mi], b[0], b[1]);
          tc::mma_16816(acc[mi][2 * n + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (slice != nk - 1) continue;

    // epilogue of the tile: softcap, label pick, mask (the last tile only),
    // online (m, l) in base 2
    const int v0 = (tile_begin + i / nk) * kTcBV;
    const bool ragged = v0 + kTcBV > p.V;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = tc::kMasked;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = v0 + n * 8 + 2 * t + e;
            float z = acc[mi][n][2 * hh + e];
            if constexpr (SOFTCAP) z = p.softcap * tanhf(z / p.softcap);
            if (v == lab[mi][hh]) ll[mi][hh] += z;
            z *= tc::kLog2e;
            if (ragged && v >= p.V) z = tc::kMasked;
            acc[mi][n][2 * hh + e] = z;
            tmax = fmaxf(tmax, z);
          }
        }
        if (tmax == tc::kMasked) continue;  // none of this thread's columns is valid
        const float m_new = fmaxf(m[mi][hh], tmax);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          sum += exp2f(acc[mi][n][2 * hh] - m_new) + exp2f(acc[mi][n][2 * hh + 1] - m_new);
        }
        l[mi][hh] = l[mi][hh] * exp2f(m[mi][hh] - m_new) + sum;
        m[mi][hh] = m_new;
      }
    }
  }

  // combine the four lanes of each row, then write the split's partials
  // (m back in base e: l = sum 2^(x - m2) = sum e^(z - m2 ln 2))
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m[mi][hh], off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l[mi][hh], off);
        ll[mi][hh] += __shfl_xor_sync(0xffffffffu, ll[mi][hh], off);
        tc::lse2_merge(m[mi][hh], l[mi][hh], m_o, l_o);
      }
      const int row = row0 + warp * 32 + mi * 16 + g + 8 * hh;
      if (t == 0 && row < p.T) {
        const long long base = static_cast<long long>(blockIdx.y) * p.T + row;
        const long long plane = static_cast<long long>(p.nsplit) * p.T;
        p.part[base] = m[mi][hh] * tc::kLn2;
        p.part[plane + base] = l[mi][hh];
        p.part[2 * plane + base] = ll[mi][hh];
      }
    }
  }
}

// (vocabulary splits, tiles a split) of the tensor-core kernel: as many
// splits as fit the row blocks into one wave of two blocks an SM, so the
// wave has no ragged tail; no split empty.
void tc_splits(int T, int V, int* nsplit, int* tiles_per_split) {
  const int n_tiles = (V + kTcBV - 1) / kTcBV;
  const int rows = (T + kTcBT - 1) / kTcBT;
  int want = kTcTargetBlocks / rows;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  *tiles_per_split = (n_tiles + want - 1) / want;
  *nsplit = (n_tiles + *tiles_per_split - 1) / *tiles_per_split;
}

cudaError_t launch_tc(const TcParams& p, float* nll, float* lse, cudaStream_t stream) {
  static_assert(kTcSmemBytes <= 232448, "shared memory per block");
  auto kernel = p.softcap != 0.f ? crossentropy_tc_kernel<true> : crossentropy_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kTcSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kTcBT - 1) / kTcBT, p.nsplit);
  kernel<<<grid, kTcThreads, kTcSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kCombineThreads = 256;
  crossentropy_combine<<<(p.T + kCombineThreads - 1) / kCombineThreads, kCombineThreads, 0,
                         stream>>>(p.part, p.nsplit, p.T, nll, lse);
  return cudaGetLastError();
}

}  // namespace

// Vocabulary splits the kernel for x's type (`x_dtype` 0: float32, 1:
// bfloat16) uses for T rows and V columns: the wrapper allocates 3 * splits *
// T floats of scratch for the partials.
extern "C" int crossentropy_splits(int T, int V, int x_dtype) {
  int nsplit, tiles;
  if (x_dtype == 1) {
    tc_splits(T, V, &nsplit, &tiles);
  } else {
    splits(T, V, &nsplit, &tiles);
  }
  return nsplit;
}

// Launches the kernel and its combine pass on `stream`; returns a cudaError_t
// as an int (0 on success).  `x_dtype` / `w_dtype`: 0 float32, 1 bfloat16.
// A float32 x takes the CUDA-core kernel with a float32 or bfloat16 W read
// through any strides.  A bfloat16 x takes the tensor-core kernel: W is then
// bfloat16 and K-major (w_sd == 1, w_sv a multiple of 8), x's depth stride 1
// and its row stride a multiple of 8, both pointers 16-byte aligned; anything
// else returns cudaErrorInvalidValue.  `labels` holds T int32 (labels64 = 0)
// or int64 (labels64 = 1) values.  `part` is device scratch of 3 *
// crossentropy_splits(T, V, x_dtype) * T floats; `nll` and `lse` are [T]
// float32 outputs.  The caller guarantees T, D, V >= 1.
extern "C" int crossentropy_launch(const void* x, int x_dtype, long long x_st, long long x_sd,
                                   const void* w, int w_dtype, long long w_sd, long long w_sv,
                                   const void* labels, int labels64, int T, int D, int V,
                                   float softcap, float* part, float* nll, float* lse,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) {
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0 && x_sd == 1 &&
                         (x_st % 8 == 0 || T == 1) && w_sd == 1 && w_sv % 8 == 0;
    if (w_dtype != 1 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
    TcParams p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.w = static_cast<const __nv_bfloat16*>(w);
    p.labels = labels;
    p.part = part;
    p.x_st = x_st;
    p.w_ld = w_sv;
    p.T = T;
    p.D = D;
    p.V = V;
    tc_splits(T, V, &p.nsplit, &p.tiles_per_split);
    p.labels64 = labels64;
    p.softcap = softcap;
    return static_cast<int>(launch_tc(p, nll, lse, s));
  }
  Params p;
  p.x = x;
  p.w = w;
  p.labels = labels;
  p.part = part;
  p.x_st = x_st;
  p.x_sd = x_sd;
  p.w_sd = w_sd;
  p.w_sv = w_sv;
  p.T = T;
  p.D = D;
  p.V = V;
  splits(T, V, &p.nsplit, &p.tiles_per_split);
  p.labels64 = labels64;
  p.softcap = softcap;
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0) err = launch<float, float>(p, nll, lse, s);
  if (x_dtype == 0 && w_dtype == 1) err = launch<float, __nv_bfloat16>(p, nll, lse, s);
  return static_cast<int>(err);
}
