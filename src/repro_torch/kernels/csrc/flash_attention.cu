// Flash-attention forward kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_kernel, the
// Pallas TPU kernel that flash_attention launches through pl.pallas_call.
//
// Computes, for queries Q [B, Hq, Sq, D] and keys / values K, V [B, Hkv, Skv,
// D] (float32 or bfloat16, all three of one type; query head h reads kv head
// h / (Hq / Hkv)), with a query row r at absolute position qp = q_offset + r:
//   s[r, j] = (q_r . k_j) * scale, then cap * tanh(s / cap) when cap != 0;
//   s[r, j] = -1e30 where key j is masked: j >= kv_len, or (causal) j > qp,
//             or (window > 0) qp - j >= window;
//   o_r     = sum_j softmax(s[r, :])_j v_j, accumulated in float32 and written
//             in the inputs' type.
// The TPU kernel is the case q_offset = 0, kv_len = Skv.  The model serves
// prefill against a KV cache through the two extra arguments: its queries
// start at the cache index and only the first kv_len cache slots are filled.
//
// Design.  The TPU kernel walks a (batch, head, q-block, kv-block) grid in
// order and carries the online-softmax state (m, l, acc) in VMEM scratch
// across the innermost kv axis, initialising at kv-block 0 and finalising at
// the last.  CUDA blocks run in no order, so here one block of 128 threads
// owns one (batch, head, q-block) and loops over the kv tiles itself, keeping
// (m, l, acc) in registers.  Per kv tile:
//   1. the tile's keys (transposed) and values are staged in shared memory
//      as float32; the query tile was staged once;
//   2. each thread computes a TM x TN block of the scores (rows ty*TM + i,
//      keys tx + 8*j) with float32 FMAs on the CUDA cores;
//   3. a row's running max and sum are combined across the 8 lanes that hold
//      its keys with warp shuffles; the accumulator is rescaled by
//      exp(m_old - m_new);
//   4. the probabilities go through shared memory, and each thread adds
//      P V into its TM x (D / 8) accumulator block (columns tx + 8*c).
// Only the kv tiles that meet the block's causal / window band and lie below
// kv_len are visited; every row has at least one key it may attend to (the
// wrapper checks this), so the skipped tiles would only have added exp(-1e30
// - m) = 0.  The row stride of every shared tile is padded by one float, so a
// warp's reads hit distinct banks or broadcast.  The heaviest causal
// q-blocks are launched first.  Inputs are addressed through element strides
// (the head dimension contiguous), so the model's [B, S, H, D] tensors and
// the TPU layout [B, H, S, D] are read without a transposed copy.
//
// Bound on this card.  Two matrix products per tile: 4 * D FLOPs per
// (query, visited key) pair, and q/k/v/o read or written once.  At the main
// path's prefill shapes the FLOPs dominate (tinyllama-1.1b: 1.4e11 FLOPs
// against 151 MB), so the bound is the tensor cores' bf16 rate.  This first
// kernel runs the products on the CUDA cores in float32, below even the
// 67 TFLOP/s float32 rate (shared-memory loads bound the inner loops); wgmma
// on the tensor cores is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowGroups = 16;  // ty = threadIdx.x / 8
constexpr int kColLanes = 8;    // tx = threadIdx.x % 8: the lanes that share a row
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of (batch, position, head); the head dimension is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Skv, group;
  int causal, window, q_offset, kv_len;
  float scale, softcap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Tile shapes per head width (BQ query rows, BK keys a tile): they keep the
// float32 accumulator at 64 registers or fewer a thread and the shared tiles
// small enough for 2-3 blocks an SM.
template <int D>
struct Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
};
template <>
struct Tiles<128> {
  static constexpr int BQ = 64;
  static constexpr int BK = 32;
};
template <>
struct Tiles<256> {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
};

// Dynamic shared memory of one block: the padded q, k^T, v and P tiles.
template <int D>
constexpr size_t smem_bytes() {
  constexpr int BQ = Tiles<D>::BQ;
  constexpr int BK = Tiles<D>::BK;
  return sizeof(float) * (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  constexpr int TM = BQ / kRowGroups;  // query rows per thread
  constexpr int TN = BK / kColLanes;   // keys per thread in a score tile
  constexpr int TD = D / kColLanes;    // output columns per thread
  constexpr int QS = D + 1;            // padded row strides
  constexpr int KS = BK + 1;
  constexpr int PS = BK + 1;
  static_assert(TM * kRowGroups == BQ && TN * kColLanes == BK && TD * kColLanes == D,
                "tile sizes must divide among the threads");

  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][QS]
  float* kt_s = q_s + BQ * QS;   // [D][KS]: keys transposed
  float* v_s = kt_s + D * KS;    // [BK][D]
  float* p_s = v_s + BK * D;     // [BQ][PS]: probabilities of the current tile

  const int tid = threadIdx.x;
  const int ty = tid / kColLanes;
  const int tx = tid % kColLanes;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int row = q0 + r;
    q_s[r * QS + d] = row < p.Sq ? to_f32(q[row * p.q_ss + d]) : 0.f;
  }

  float acc[TM][TD];
  float m[TM];
  float l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }

  // the kv range this block's rows can see
  const int qp_lo = p.q_offset + q0;
  const int qp_hi = p.q_offset + min(q0 + BQ, p.Sq) - 1;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, qp_hi + 1);
  int kv_begin = p.window > 0 ? max(0, qp_lo - p.window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q_s staged)
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D;
      const int d = i % D;
      const int key = kv0 + c;
      float kval = 0.f;
      float vval = 0.f;
      if (key < p.Skv) {
        kval = to_f32(k[key * p.k_ss + d]);
        vval = to_f32(v[key * p.v_ss + d]);
      }
      kt_s[d * KS + c] = kval;
      v_s[c * D + d] = vval;
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TM];
      float kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = q_s[(ty * TM + i) * QS + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = kt_s[d * KS + tx + kColLanes * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qp = qp_lo + ty * TM + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = kv0 + tx + kColLanes * j;
        float x = s[i][j] * p.scale;
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = key < p.kv_len;
        if (p.causal) ok = ok && key <= qp;
        if (p.window > 0) ok = ok && qp - key < p.window;
        x = ok ? x : kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kColLanes; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float e = expf(s[i][j] - m_new);
        row_sum += e;
        p_s[(ty * TM + i) * PS + tx + kColLanes * j] = e;
      }
#pragma unroll
      for (int off = 1; off < kColLanes; off <<= 1) {
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's probabilities are written and read by the 8 lanes of one warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[TM];
      float vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = p_s[(ty * TM + i) * PS + j];
#pragma unroll
      for (int c = 0; c < TD; ++c) vv[c] = v_s[j * D + tx + kColLanes * c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row < p.Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* out = o + row * p.o_ss;
#pragma unroll
      for (int c = 0; c < TD; ++c) out[tx + kColLanes * c] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, int Hq, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ;
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= 232448, "shared memory per block");
  auto kernel = flash_attention_kernel<T, D, BQ, Tiles<D>::BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int Hq, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(p, B, Hq, stream);
    case 16: return launch<T, 16>(p, B, Hq, stream);
    case 32: return launch<T, 32>(p, B, Hq, stream);
    case 64: return launch<T, 64>(p, B, Hq, stream);
    case 128: return launch<T, 128>(p, B, Hq, stream);
    case 256: return launch<T, 256>(p, B, Hq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory in bytes a block of the kernel takes for head width
// D, or -1 for a width it is not built for.
extern "C" int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 8: return static_cast<int>(smem_bytes<8>());
    case 16: return static_cast<int>(smem_bytes<16>());
    case 32: return static_cast<int>(smem_bytes<32>());
    case 64: return static_cast<int>(smem_bytes<64>());
    case 128: return static_cast<int>(smem_bytes<128>());
    case 256: return static_cast<int>(smem_bytes<256>());
    default: return -1;
  }
}

// Launches the kernel on `stream` and returns a cudaError_t as an int (0 on
// success).  `q`, `k`, `v`, `o` are device pointers of one type (`dtype` 0:
// float32, 1: bfloat16); `strides` points to 12 host int64 element strides,
// (batch, position, head) for q, k, v and o in that order, the head
// dimension being contiguous.  The caller guarantees B, Hq, Sq >= 1, Hq a
// multiple of Hkv, 1 <= kv_len <= Skv, D in {8, 16, 32, 64, 128, 256}, and that
// every query row has a key it may attend to.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int Hq, int Hkv, int Sq, int Skv,
                                      int D, const long long* strides, int causal, int window,
                                      float softcap, int q_offset, int kv_len, float scale,
                                      void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = Hq / Hkv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0   ? dispatch<float>(p, B, Hq, D, s)
                          : dtype == 1 ? dispatch<__nv_bfloat16>(p, B, Hq, D, s)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
