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
// Two kernels, chosen by the inputs' type (a fixed rule, not a fallback):
// bfloat16 inputs, the model's compute type in training, serving and tuning,
// always take the tensor-core kernel; float32 inputs take the CUDA-core
// kernel, whose float32 products the float32 parity checks rely on (TF32
// products would not hold them).
//
// Design, both kernels.  The TPU kernel walks a (batch, head, q-block,
// kv-block) grid in order and carries the online-softmax state (m, l, acc)
// in VMEM scratch across the innermost kv axis, initialising at kv-block 0
// and finalising at the last.  CUDA blocks run in no order, so here one
// block owns one (batch, head, q-block) and loops over the kv tiles itself,
// keeping (m, l, acc) in registers.  Only the kv tiles that meet the block's
// causal / window band and lie below kv_len are visited; every row has at
// least one key it may attend to (the wrapper checks this), so the skipped
// tiles would only have added exp(-1e30 - m) = 0.  The heaviest causal
// q-blocks are launched first.  Inputs are addressed through element
// strides (the head dimension contiguous), so the model's [B, S, H, D]
// tensors and the TPU layout [B, H, S, D] are read without a transposed
// copy.
//
// bfloat16: tensor cores (flash_attention_tc_kernel; the FA2 shape, with
// mma.sync and cp.async from tensor_core.cuh).  A block of 4 warps owns 64
// query rows, 16 a warp.  The q tile is staged once; the k and v tiles
// (64 keys, 32 at D = 256) stream through a two-stage shared-memory ring
// filled by cp.async, the next tile's copies in flight while the current
// one is computed.  Per tile, each warp:
//   1. S = Q K^T on the tensor cores (mma.sync.m16n8k16, bf16 operands from
//      ldmatrix, float32 accumulators), 16 rows x the tile's keys;
//   2. the scale and softcap (tanhf; a separate instance of the kernel
//      without it) on the accumulator fragment, the masks only on tiles that
//      cross the causal / window / kv_len edge, then the online softmax in
//      base 2: the row max across the 4 lanes of a quad, one rescale of the
//      output accumulator per tile, P = 2^(x - m) on the special-function
//      unit (ex2.approx);
//   3. P split in registers into two bf16 terms, hi = round(P) and lo =
//      round(P - hi) (the C fragment of S is the A fragment of P V, no
//      shared-memory round trip);
//   4. O += hi V + lo V on the tensor cores, V read once with ldmatrix.trans.
// The split keeps P to about 2^-17 of itself, as the float32 plain version
// and the float32 kernel keep it: with P rounded once to bf16 (2^-9), the
// served tinyllama-1.1b's last-token logits on the kernel and on the plain
// version lay 8.4e-2 apart on the H100, over the 8e-2 the two engines are
// held to (6.6e-2 with the split); the second product costs about a tenth
// of the kernel's time at D = 64.
// Heads narrower than 16, the MMA's depth, are zero-padded in shared memory
// (D = 8 runs as 16).  Edges are masked on the fragment: rows past Sq and
// keys past kv_len are zero-filled by the copies, never padded in device
// memory.  The copies need 16-byte aligned rows: every (batch, position,
// head) stride a multiple of 8 elements and 16-byte aligned bases, which the
// wrapper checks (the model's [B, S, H, D] projections and caches meet it,
// since D is a multiple of 8).
//
// float32: CUDA cores (flash_attention_kernel, the port's first kernel).  A
// block of 128 threads owns a q-block; per kv tile:
//   1. the tile's keys (transposed) and values are staged in shared memory
//      as float32; the query tile was staged once;
//   2. each thread computes a TM x TN block of the scores (rows ty*TM + i,
//      keys tx + 8*j) with float32 FMAs on the CUDA cores;
//   3. a row's running max and sum are combined across the 8 lanes that hold
//      its keys with warp shuffles; the accumulator is rescaled by
//      exp(m_old - m_new);
//   4. the probabilities go through shared memory, and each thread adds
//      P V into its TM x (D / 8) accumulator block (columns tx + 8*c).
// The row stride of every shared tile is padded by one float, so a warp's
// reads hit distinct banks or broadcast.
//
// Bound on this card.  Two matrix products per tile: 4 * D FLOPs per
// (query, visited key) pair, and q/k/v/o read or written once.  At the main
// path's prefill shapes the FLOPs dominate (tinyllama-1.1b: 1.4e11 FLOPs
// against 151 MB), so the bound is the tensor cores' bf16 rate, 989 TFLOP/s.
// The bfloat16 kernel runs its products there, but through mma.sync, which
// reaches a fraction of the rate that wgmma (with TMA feeding a ring and
// warp-specialised producers, the FA3 shape) reaches; its shared-memory
// reads (q and k/v fragments re-read by each warp of 16 rows) and the
// softmax's exp and shuffles between the two products also hold it back.
// The float32 kernel runs on the CUDA cores below the 67 TFLOP/s float32
// rate (shared-memory loads bound its inner loops).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

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
  // the tensor-core kernel's scores in base 2: s * scale * log2(e), or with a
  // softcap cap * log2(e) * tanh(s * scale / cap)
  float scale_log2, scale_over_cap, cap_log2;
};

// The CUDA-core kernel is instantiated for float32 alone (bfloat16 takes
// the tensor-core kernel).
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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


// -- bfloat16: tensor cores -------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // query rows a block: one 16-row MMA tile a warp

// Keys a kv tile: 64, and 32 at D = 256, where the 16 x 256 float32 output
// accumulator already takes 128 registers a thread and the ring's shared
// tiles would otherwise leave one block an SM.  (Two row tiles a warp, so
// that each k / v fragment feeds two products, ran slower at D = 64 on the
// H100: 255 registers and spills.)
template <int D>
struct TcTiles {
  static constexpr int DP = D < 16 ? 16 : D;  // depth padded to the MMA's 16
  static constexpr int LD = DP + 8;           // shared row stride (tensor_core.cuh)
  static constexpr int BN = D >= 256 ? 32 : 64;
};

// Dynamic shared memory of one block: the q tile and two stages of k and v.
template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * TcTiles<D>::LD * (kTcRows + 4 * TcTiles<D>::BN);
}

template <int D, int BN, bool SOFTCAP>
__global__ void __launch_bounds__(kTcThreads) flash_attention_tc_kernel(const Params p) {
  using tc::bf16;
  constexpr int DP = TcTiles<D>::DP;
  constexpr int LD = TcTiles<D>::LD;
  constexpr int NB = BN / 8;   // 8-key column blocks of a score tile
  constexpr int ON = DP / 8;   // 8-wide column blocks of the output
  static_assert(BN % 16 == 0 && DP % 16 == 0, "MMA tiles");

  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][LD]
  bf16* k_s = q_s + kTcRows * LD;                // [2][BN][LD]
  bf16* v_s = k_s + 2 * BN * LD;                 // [2][BN][LD]

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // the kv range this block's rows can see
  const int qp_lo = p.q_offset + q0;
  const int qp_hi = p.q_offset + min(q0 + kTcRows, p.Sq) - 1;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, qp_hi + 1);
  int kv_begin = p.window > 0 ? max(0, qp_lo - p.window + 1) : 0;
  kv_begin = (kv_begin / BN) * BN;
  const int n_tiles = (kv_end - kv_begin + BN - 1) / BN;

  tc::load_tile<kTcRows, DP, LD, kTcThreads>(q_s, q + q0 * p.q_ss, p.q_ss, p.Sq - q0, D);
  tc::load_tile<BN, DP, LD, kTcThreads>(k_s, k + kv_begin * p.k_ss, p.k_ss,
                                        p.kv_len - kv_begin, D);
  tc::load_tile<BN, DP, LD, kTcThreads>(v_s, v + kv_begin * p.v_ss, p.v_ss,
                                        p.kv_len - kv_begin, D);
  tc::cp_async_commit();

  const int a_off = tc::a_offset<LD>(lane);
  const int b_off = tc::b_offset<LD>(lane);
  const bf16* q_warp = q_s + warp * 16 * LD + a_off;
  const int qp0 = qp_lo + warp * 16 + g;  // this thread's rows: positions qp0 and qp0 + 8
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {tc::kMasked, tc::kMasked};  // base-2 running max of rows g, g + 8
  float l[2] = {0.f, 0.f};                  // this thread's share of their sums

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = kv_begin + j * BN;
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      tc::load_tile<BN, DP, LD, kTcThreads>(k_s + st * BN * LD, k + (kv0 + BN) * p.k_ss, p.k_ss,
                                            p.kv_len - kv0 - BN, D);
      tc::load_tile<BN, DP, LD, kTcThreads>(v_s + st * BN * LD, v + (kv0 + BN) * p.v_ss, p.v_ss,
                                            p.kv_len - kv0 - BN, D);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and the q tile) has landed for every thread
    const bf16* ks = k_s + (j & 1) * BN * LD;
    const bf16* vs = v_s + (j & 1) * BN * LD;

    // 1. S = Q K^T
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, q_warp + kk * 16);
#pragma unroll
      for (int n = 0; n < NB / 2; ++n) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, ks + n * 16 * LD + b_off + kk * 16);
        tc::mma_16816(s[2 * n], a, bk[0], bk[1]);
        tc::mma_16816(s[2 * n + 1], a, bk[2], bk[3]);
      }
    }

    // 2. scale, softcap and masks in base 2 (the masks only on tiles that
    // cross the causal / window / kv_len edge); the online softmax
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = SOFTCAP ? p.cap_log2 * tanhf(s[n][e] * p.scale_over_cap)
                          : s[n][e] * p.scale_log2;
      }
    }
    if (kv0 + BN > p.kv_len || (p.causal && kv0 + BN - 1 > qp_lo) ||
        (p.window > 0 && qp_hi - kv0 >= p.window)) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + n * 8 + 2 * t + (e & 1);
          const int qp = qp0 + (e >> 1) * 8;
          bool ok = key < p.kv_len;
          if (p.causal) ok = ok && key <= qp;
          if (p.window > 0) ok = ok && qp - key < p.window;
          if (!ok) s[n][e] = tc::kMasked;
        }
      }
    }
    float mx[2] = {tc::kMasked, tc::kMasked};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], tc::quad_max(mx[r]));
      const float alpha = tc::exp2_approx(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        s[n][2 * r] = tc::exp2_approx(s[n][2 * r] - mn);
        s[n][2 * r + 1] = tc::exp2_approx(s[n][2 * r + 1] - mn);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // 3-4. O += P V with P split into two bf16 terms in registers (the C
    // fragment of S is the A fragment of P V)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a0..a3: rows g / g + 8 of key blocks 2 kk, 2 kk + 1
        tc::split_bf16(s[2 * kk + (r >> 1)][2 * (r & 1)], s[2 * kk + (r >> 1)][2 * (r & 1) + 1],
                       hi[r], lo[r]);
      }
#pragma unroll
      for (int n = 0; n < ON / 2; ++n) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, vs + kk * 16 * LD + a_off + n * 16);
        tc::mma_16816(acc[2 * n], hi, bv[0], bv[1]);
        tc::mma_16816(acc[2 * n + 1], hi, bv[2], bv[3]);
        tc::mma_16816(acc[2 * n], lo, bv[0], bv[1]);
        tc::mma_16816(acc[2 * n + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage j & 1 is refilled with tile j + 2 in the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / fmaxf(tc::quad_sum(l[r]), 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < p.Sq) {
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        if (n * 8 < D) {  // the zero-padded columns of D = 8 are not written
          *reinterpret_cast<__nv_bfloat162*>(o + row * p.o_ss + n * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(const Params& p, int B, int Hq, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static_assert(smem <= 232448, "shared memory per block");
  auto kernel = p.softcap != 0.f ? flash_attention_tc_kernel<D, TcTiles<D>::BN, true>
                                 : flash_attention_tc_kernel<D, TcTiles<D>::BN, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kTcRows - 1) / kTcRows, Hq, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// -- float32: CUDA cores and bfloat16: tensor cores, by head width -------------------------

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

cudaError_t dispatch_f32(const Params& p, int B, int Hq, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<float, 8>(p, B, Hq, stream);
    case 16: return launch<float, 16>(p, B, Hq, stream);
    case 32: return launch<float, 32>(p, B, Hq, stream);
    case 64: return launch<float, 64>(p, B, Hq, stream);
    case 128: return launch<float, 128>(p, B, Hq, stream);
    case 256: return launch<float, 256>(p, B, Hq, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const Params& p, int B, int Hq, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch_tc<8>(p, B, Hq, stream);
    case 16: return launch_tc<16>(p, B, Hq, stream);
    case 32: return launch_tc<32>(p, B, Hq, stream);
    case 64: return launch_tc<64>(p, B, Hq, stream);
    case 128: return launch_tc<128>(p, B, Hq, stream);
    case 256: return launch_tc<256>(p, B, Hq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory in bytes a block of the kernel for `dtype` (0:
// float32, 1: bfloat16) takes at head width D, or -1 for a width or type it
// is not built for.
extern "C" int flash_attention_smem_bytes(int D, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (D) {
    case 8: return static_cast<int>(dtype ? tc_smem_bytes<8>() : smem_bytes<8>());
    case 16: return static_cast<int>(dtype ? tc_smem_bytes<16>() : smem_bytes<16>());
    case 32: return static_cast<int>(dtype ? tc_smem_bytes<32>() : smem_bytes<32>());
    case 64: return static_cast<int>(dtype ? tc_smem_bytes<64>() : smem_bytes<64>());
    case 128: return static_cast<int>(dtype ? tc_smem_bytes<128>() : smem_bytes<128>());
    case 256: return static_cast<int>(dtype ? tc_smem_bytes<256>() : smem_bytes<256>());
    default: return -1;
  }
}

// Launches the kernel on `stream` and returns a cudaError_t as an int (0 on
// success).  `q`, `k`, `v`, `o` are device pointers of one type (`dtype` 0:
// float32, the CUDA-core kernel; 1: bfloat16, the tensor-core kernel);
// `strides` points to 12 host int64 element strides, (batch, position, head)
// for q, k, v and o in that order, the head dimension being contiguous.  The
// caller guarantees B, Hq, Sq >= 1, Hq a multiple of Hkv, 1 <= kv_len <= Skv,
// D in {8, 16, 32, 64, 128, 256}, that every query row has a key it may
// attend to and, for bfloat16, 16-byte aligned pointers and strides that are
// multiples of 8.
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
  p.scale_log2 = scale * tc::kLog2e;
  p.scale_over_cap = softcap != 0.f ? scale / softcap : 0.f;
  p.cap_log2 = softcap * tc::kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0   ? dispatch_f32(p, B, Hq, D, s)
                          : dtype == 1 ? dispatch_bf16(p, B, Hq, D, s)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
