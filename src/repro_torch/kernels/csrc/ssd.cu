// Mamba2 chunked SSD scan kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd.py::ssd_kernel, the Pallas TPU kernel that
// ssd launches through pl.pallas_call.
//
// Computes what the reference's model computes (repro/models/mamba2.py::
// ssd_chunked), in float32.  Per (batch b, head h), with head h reading group
// g = h / (H / G) of B and C, the steps cut into chunks of L steps (the last
// one ragged), and within a chunk cum_t the inclusive cumsum of dt_t * A_h,
// u_t = x_t * dt_t, and h_in the state [P, N] entering the chunk:
//   y_t   = sum_{s <= t} exp(cum_t - cum_s) (C_t . B_s) u_s + exp(cum_t) h_in C_t
//   h_out = exp(cum_last) h_in + sum_s exp(cum_last - cum_s) u_s B_s^T
// The state entering the first chunk is the initial state (zero without
// one); y [B, S, H, P] and the final state [B, H, P, N] are written in float32.
// Beside the TPU kernel (B / C folded per batch*head, a zero initial state,
// S a multiple of the chunk) this takes B / C per group, an initial state, a
// ragged last chunk, and the model's layouts through element strides: x [B,
// S, H, P], dt [B, S, H], B / C [B, S, G, N] (the last dimension contiguous),
// so the model's slices of its conv output are read without a copy.
//
// Two kernels, chosen by the inputs' type (a fixed rule, not a fallback):
// bfloat16 x, B and C, the model's compute type in training, serving and
// tuning, always take the tensor-core kernel (ssd_tc_kernel); float32 inputs
// take the CUDA-core kernel (ssd_kernel), whose float32 products the float32
// parity checks rely on.
//
// Design, both kernels.  The TPU kernel walks a (batch*head, chunk) grid
// whose chunk axis runs in order, carrying the state in VMEM scratch from
// one chunk to the next.  CUDA blocks run in no order, so here one block of
// 256 threads owns one (batch, head) and loops over the chunks itself,
// keeping the state [P, N] on the SM as float32 for the whole loop.
//
// bfloat16: tensor cores (ssd_tc_kernel; mma.sync.m16n8k16 and ldmatrix
// from tensor_core.cuh, bf16 operands, float32 accumulators).  x, B and C
// stay exact in bf16 in shared memory; every float32 operand of a product is
// split into bf16 terms (hi = round(v), then the rounded remainders).  With
// dt folded into the decay matrix, per chunk:
//   M'[t, s] = exp(cum_t - cum_s) dt_s (C_t . B_s)   for s <= t, else 0
//   y        = exp(cum_t) (C h_in^T) + M' X
//   h_out    = exp(cum_last) h_in + X^T (w o dt o B),  w_s = exp(cum_last - cum_s)
// so C B^T multiplies exact bf16 operands and M' X multiplies the exact X
// by M' as two terms (to about 2^-16 of M').  The state's two products take
// their float32 operand, h_in and w dt B, as three terms (to about 2^-24,
// float32's grade): the state sums the whole sequence, and at zamba2's
// widths a slow head (A = -0.001, |y| up to about 600) lands 1.2 from
// float64 with one bf16 rounding of the three operands, 2.1e-3 with two
// terms each and 7.7e-4 with this split (tests/test_torch_ssd.py emulates
// the three on the CPU), against the 2e-3 the kernel is held to.  The
// chunk's x, B, C and dt are staged by cp.async at the top of its step.
// The state stays in registers, as float32: warp w owns its N
// columns [8 w, 8 w + 8) for every P row, and writes its three bf16 terms to
// shared memory after each update, where every warp reads them as the B
// operand of C h_in^T.  Per chunk:
//   1. warp 0 takes the inclusive cumsum of dt * A with warp shuffles (steps
//      past the sequence's end have dt = 0: they leave the state as it is),
//      then exp(cum_t) and w_s dt_s;
//   2. y: the chunk's rows are cut in 16-row strips, and the 8 warps take a
//      pair of strips (i, last - i) and one half of P each, so every warp
//      has the same number of 16 x 16 blocks below the diagonal at L = 128
//      (a chunk of fewer than 8 strips gives the second strip of a pair only
//      where no warp's first strip is it).  Per strip:
//      C h_in^T from the state's terms (skipped while the state is zero),
//      scaled by exp(cum_t); then for each block s <= t only (the tiles
//      above the diagonal are never computed): C B^T on the tensor cores, M'
//      on the accumulator fragment (the exp taken only where s <= t, so the
//      upper triangle is never exponentiated), split into hi / lo A
//      fragments in registers (the C fragment of C B^T is the A fragment of
//      M' X, no shared-memory round trip), and M' X with X read by
//      ldmatrix.trans;
//   3. the state's product X^T (w dt B) for the warp's N columns, each B
//      fragment scaled and split once; after a barrier (every warp has read
//      h_in's terms) the warp updates its registers to decay h_in + the
//      product and writes the new terms.
// Three barriers a chunk.  Widths P, N of at most 64 (zero-padded to
// multiples of 16 in shared memory; the tune study's N = 8, P = 16 too).  At
// L = 128 a block takes 83 KB of shared memory with one chunk staged, so
// two blocks of 8 warps run per SM (staging the next chunk during this one,
// 137 KB and one block an SM, measured slower: PERF.md), and the (H, B)
// grid gives zamba2's prefill 512 blocks.  The copies need 16-byte aligned rows: every stride of
// x, B and C a multiple of 8 elements and 16-byte aligned bases, which the
// wrapper checks (the model's slices of its conv output, of row stride H P
// + 2 G N, meet it).
//
// float32: CUDA cores (ssd_kernel, the port's first SSD kernel).  Per chunk:
//   1. dt is staged; warp 0 takes the inclusive cumsum of dt * A with warp
//      shuffles, then exp(cum_t) and exp(cum_last - cum_t);
//   2. u = x * dt, B and C of the head's group are staged in shared memory as
//      float32;
//   3. M[t][s] = exp(cum_t - cum_s) (C_t . B_s) for s <= t, else 0: each
//      thread of a 16 x 16 grid computes rows ty + 16 i and columns tx + 16 j
//      with float32 FMAs.  The exp is evaluated only for s <= t, where
//      cum_t - cum_s <= 0: the upper triangle is never exponentiated (the TPU
//      kernel exponentiates the whole tile and masks after, which can
//      overflow to inf there);
//   4. y[t][p] = sum_s M[t][s] u[s][p] + exp(cum_t) sum_n C[t][n] h_in[p][n],
//      written to device memory;
//   5. h_out[p][n] = exp(cum_last) h_in[p][n] + sum_s w_s u[s][p] B[s][n],
//      in place in shared memory.
// Every shared tile's row stride is padded to an odd number of floats, so the
// 16 columns a half-warp reads hit distinct banks.  Tiles are padded with
// zeros to multiples of 16 rows and columns.  At L = 128, P = N = 64 a block
// takes 179 KB of shared memory, so one block runs per SM.
//
// Bound on this card.  The function needs, per chunk and per (batch, head),
// (2 N + 2 P) FLOPs for each of the L (L + 1) / 2 pairs s <= t (C_t . B_s
// and M u) and 4 L P N for the state's read into y and its update; x, dt,
// B, C are read once and y and the state written once.  At zamba2's prefill
// (B = 8, S = 2048, H = 64, P = N = 64, L = 128, an initial state, bf16) that
// is 3.4e10 FLOPs against 0.43 GB: 0.51 ms at the 67 TFLOP/s float32 rate
// (the reference computes the scan in float32), 0.13 ms for the bytes at
// 3.35 TB/s, 0.035 ms for the FLOPs at the 989 TFLOP/s bf16 tensor-core
// rate.  The split operands double M' X and triple C h_in^T and the state's
// product on the tensor cores, and still the bytes bound the bf16 kernel; the float32 kernel
// runs on the CUDA cores, bound by shared-memory loads, and spends FMAs on
// the masked upper triangle of M.

#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;  // the 16 x 16 thread grid: ty = tid / 16, tx = tid % 16
constexpr int kMaxTiles = 8;  // L, P, N of at most 8 x 16 = 128

struct Params {
  const void* x;
  const void* B;
  const void* C;
  const float* dt;
  const float* A;
  const float* init;  // null: a zero initial state
  float* y;
  float* final_state;
  int S, H, rep, P, N, L;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of one block of the float32 kernel, in floats, for chunk
// length L and widths P, N.
__host__ __device__ inline int smem_floats(int L, int P, int N) {
  const int LP = round16(L), PP = round16(P), NP = round16(N);
  return LP * (PP + 1)          // u
         + 2 * LP * (NP + 1)    // B, C
         + LP * (LP + 1)        // M
         + PP * (NP + 1)        // state
         + 4 * LP;              // dt, cum, exp(cum), exp(cum_last - cum)
}

// MT: the most 16-wide tiles of P and of N a thread's registers hold (P, N
// <= 16 MT); the chunk's rows always take up to kMaxTiles.
template <int MT>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int LP = round16(p.L), PP = round16(p.P), NP = round16(p.N);
  const int US = PP + 1, BS = NP + 1, MS = LP + 1, SS = NP + 1;
  float* u_s = smem;                // [LP][US]
  float* b_s = u_s + LP * US;       // [LP][BS]
  float* c_s = b_s + LP * BS;       // [LP][BS]
  float* m_s = c_s + LP * BS;       // [LP][MS]
  float* st_s = m_s + LP * MS;      // [PP][SS]
  float* dt_s = st_s + PP * SS;     // [LP]
  float* cum_s = dt_s + LP;         // [LP]
  float* e_s = cum_s + LP;          // [LP] exp(cum_t)
  float* w_s = e_s + LP;            // [LP] exp(cum_last - cum_t)

  const int tid = threadIdx.x;
  const int ty = tid / kGrid;
  const int tx = tid % kGrid;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / p.rep;
  const int LT = LP / kGrid, PT = PP / kGrid, NT = NP / kGrid;
  const float a_h = p.A[h];

  const float* x = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* Bp = static_cast<const float*>(p.B) + b * p.b_sb + g * p.b_sg;
  const float* Cp = static_cast<const float*>(p.C) + b * p.c_sb + g * p.c_sg;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  float* y = p.y + ((long long)b * p.S * p.H + h) * p.P;  // y[b, t, h, :] at + t * H * P
  const long long y_ss = (long long)p.H * p.P;

  // the initial state, zero-padded to PP x NP
  const float* init = p.init ? p.init + ((long long)b * p.H + h) * p.P * p.N : nullptr;
  for (int i = tid; i < PP * NP; i += kThreads) {
    const int r = i / NP, c = i % NP;
    st_s[r * SS + c] = (init && r < p.P && c < p.N) ? init[r * p.N + c] : 0.f;
  }

  for (int t0 = 0; t0 < p.S; t0 += p.L) {
    const int len = min(p.L, p.S - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int t = tid; t < LP; t += kThreads) dt_s[t] = t < len ? dt[(t0 + t) * p.dt_ss] : 0.f;
    __syncthreads();

    if (tid < 32) {
      // inclusive cumsum of dt * A over LP <= 128 steps: 4 consecutive steps a lane
      const int lane = tid;
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        run += t < LP ? dt_s[t] * a_h : 0.f;
        v[k] = run;
      }
      float incl = run;  // the lane's sum, scanned across the warp
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);  // the lanes below, summed
      if (lane == 0) before = 0.f;
      const float last = __shfl_sync(0xffffffffu, incl, 31);  // cum of the last step
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        if (t < LP) {
          const float c = before + v[k];
          cum_s[t] = c;
          e_s[t] = expf(c);
          w_s[t] = expf(last - c);
        }
      }
    } else {
      // stage u = x * dt, B and C (zero rows past the chunk's end)
      for (int i = tid - 32; i < LP * PP; i += kThreads - 32) {
        const int t = i / PP, c = i % PP;
        u_s[t * US + c] =
            (t < len && c < p.P) ? x[(t0 + t) * p.x_ss + c] * dt_s[t] : 0.f;
      }
      for (int i = tid - 32; i < LP * NP; i += kThreads - 32) {
        const int t = i / NP, c = i % NP;
        const bool in = t < len && c < p.N;
        b_s[t * BS + c] = in ? Bp[(t0 + t) * p.b_ss + c] : 0.f;
        c_s[t * BS + c] = in ? Cp[(t0 + t) * p.c_ss + c] : 0.f;
      }
    }
    __syncthreads();

    // 3. M = (C B^T) o decay, lower triangle
    {
      float acc[kMaxTiles][kMaxTiles];
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < NP; ++n) {
        float cv[kMaxTiles], bv[kMaxTiles];
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          cv[i] = i < LT ? c_s[(ty + kGrid * i) * BS + n] : 0.f;
          bv[i] = i < LT ? b_s[(tx + kGrid * i) * BS + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
          for (int j = 0; j < kMaxTiles; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) {
        if (i >= LT) continue;
        const int t = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          if (j >= LT) continue;
          const int s = tx + kGrid * j;
          m_s[t * MS + s] = s <= t ? expf(cum_s[t] - cum_s[s]) * acc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y = M u + (exp(cum) C) h_in^T, rows ty + 16 i, columns tx + 16 j
    {
      float acc[kMaxTiles][MT];
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < LP; ++s) {
        float mv[kMaxTiles], uv[MT];
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) mv[i] = i < LT ? m_s[(ty + kGrid * i) * MS + s] : 0.f;
#pragma unroll
        for (int j = 0; j < MT; ++j) uv[j] = j < PT ? u_s[s * US + tx + kGrid * j] : 0.f;
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(mv[i], uv[j], acc[i][j]);
      }
      float et[kMaxTiles];
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) et[i] = i < LT ? e_s[ty + kGrid * i] : 0.f;
      for (int n = 0; n < NP; ++n) {
        float cv[kMaxTiles], hv[MT];
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i)
          cv[i] = i < LT ? et[i] * c_s[(ty + kGrid * i) * BS + n] : 0.f;
#pragma unroll
        for (int j = 0; j < MT; ++j) hv[j] = j < PT ? st_s[(tx + kGrid * j) * SS + n] : 0.f;
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) {
        const int t = ty + kGrid * i;
        if (i >= LT || t >= len) continue;
        float* yr = y + (long long)(t0 + t) * y_ss;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int c = tx + kGrid * j;
          if (j < PT && c < p.P) yr[c] = acc[i][j];
        }
      }
    }
    __syncthreads();  // every thread has read h_in

    // 5. h_out = exp(cum_last) h_in + sum_s w_s u_s B_s^T, rows ty + 16 i, columns tx + 16 j
    {
      const float chunk_decay = e_s[LP - 1];
      float acc[MT][MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < LP; ++s) {
        const float ws = w_s[s];
        float uv[MT], bv[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) uv[i] = i < PT ? u_s[s * US + ty + kGrid * i] * ws : 0.f;
#pragma unroll
        for (int j = 0; j < MT; ++j) bv[j] = j < NT ? b_s[s * BS + tx + kGrid * j] : 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(uv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= PT) continue;
        const int r = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (j >= NT) continue;
          const int c = tx + kGrid * j;
          st_s[r * SS + c] = chunk_decay * st_s[r * SS + c] + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* fin = p.final_state + ((long long)b * p.H + h) * p.P * p.N;
  for (int i = tid; i < p.P * p.N; i += kThreads) {
    const int r = i / p.N, c = i % p.N;
    fin[i] = st_s[r * SS + c];
  }
}

// ---- bfloat16: tensor cores ------------------------------------------------------

using tc::bf16;

constexpr int kTcThreads = 256;           // 8 warps
constexpr int kTcWidth = 64;              // P and N of at most 64
constexpr int kTcLd = kTcWidth + 8;       // bf16 tile row stride (tensor_core.cuh's rule)
constexpr int kTcBlocksPerSm = 2;

// Dynamic shared memory of one block of the tensor-core kernel at chunk
// length L (rows padded to LP = round16(L)): the chunk's x, B, C tiles and
// dt, the state's three bf16 terms, and cum, exp(cum), w dt.
__host__ __device__ inline int tc_smem_bytes(int L) {
  const int LP = round16(L);
  return 3 * LP * kTcLd * 2 + LP * 4 + 3 * kTcWidth * kTcLd * 2 + 3 * LP * 4;
}

// 4-byte asynchronous copy global -> shared; `bytes` 0 zero-fills it.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Stages rows [0, LP) x columns [0, W) of a bf16 tile (element (r, c) at
// src[r * ld + c]) into shared memory of row stride kTcLd with cp.async:
// rows at or past `rows` and columns at or past `cols` are zero-filled.  W
// is the padded width (a multiple of 16); `src` and `ld` give 16-byte
// aligned chunks.
__device__ __forceinline__ void tc_load_rows(bf16* dst, const bf16* src, long long ld, int LP,
                                             int W, int rows, int cols) {
  const int per_row = W / 8;
  for (int i = threadIdx.x; i < LP * per_row; i += kTcThreads) {
    const int r = i / per_row;
    const int col = (i - r * per_row) * 8;
    int bytes = 0;
    if (r < rows && col < cols) bytes = 2 * min(8, cols - col);
    tc::cp_async_16(dst + r * kTcLd + col, bytes ? src + r * ld + col : src, bytes);
  }
}

// Writes a warp's state fragments (columns [n0, n0 + 8), rows below PW) as
// three bf16 terms into shared memory, [term][p][n]: the B operand of
// C h^T for every warp.
__device__ __forceinline__ void write_state_terms(bf16* hterm, const float (&hs)[kTcWidth / 16][4],
                                                  int PW, int n0, int g, int tq) {
#pragma unroll
  for (int mt = 0; mt < kTcWidth / 16; ++mt) {
    if (mt * 16 >= PW) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      uint32_t t3[3];
      tc::split3_bf16(hs[mt][2 * rr], hs[mt][2 * rr + 1], t3[0], t3[1], t3[2]);
      const int off = (mt * 16 + g + 8 * rr) * kTcLd + n0 + 2 * tq;
#pragma unroll
      for (int term = 0; term < 3; ++term)
        *reinterpret_cast<uint32_t*>(hterm + term * kTcWidth * kTcLd + off) = t3[term];
    }
  }
}

// y and the final state of one (batch, head) on the tensor cores; P, N <= 64,
// L <= 128.  Warp w takes strips w / 2 and LT - 1 - w / 2 (the latter only
// where it is 4 or more: strips 0-3 are the first of a pair) and P columns
// [32 (w % 2), +32) of y, and owns the state's N columns [8 w, 8 w + 8) for
// every P row, in registers.
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm) ssd_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LP = round16(p.L);
  const int PW = round16(p.P), NW = round16(p.N);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                   // [x|B|C][LP][kTcLd]
  bf16* bs = xs + LP * kTcLd;
  bf16* cs = bs + LP * kTcLd;
  bf16* hterm = cs + LP * kTcLd;                                  // [3][kTcWidth][kTcLd]
  float* dts = reinterpret_cast<float*>(hterm + 3 * kTcWidth * kTcLd);  // [LP]
  float* cum = dts + LP;                                          // [LP]
  float* ecum = cum + LP;                                         // [LP] exp(cum_t)
  float* wdt = ecum + LP;                                         // [LP] w_s dt_s

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / p.rep;
  const float a_h = p.A[h];
  const bf16* x = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const bf16* Bp = static_cast<const bf16*>(p.B) + b * p.b_sb + grp * p.b_sg;
  const bf16* Cp = static_cast<const bf16*>(p.C) + b * p.c_sb + grp * p.c_sg;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  float* y = p.y + ((long long)b * p.S * p.H + h) * p.P;  // y[b, t, h, :] at + t * H * P
  const long long y_ss = (long long)p.H * p.P;
  const int n_chunks = (p.S + p.L - 1) / p.L;


  // the state's columns [n0, n0 + 8) of this warp, every row: hs[mt] holds
  // rows 16 mt + g (0, 1) and + 8 (2, 3), columns n0 + 2 tq, + 1
  const int n0 = warp * 8;
  const bool owns_state = n0 < NW;
  float hs[kTcWidth / 16][4];
  const float* init = p.init ? p.init + ((long long)b * p.H + h) * p.P * p.N : nullptr;
#pragma unroll
  for (int mt = 0; mt < kTcWidth / 16; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = mt * 16 + g + 8 * (r >> 1), col = n0 + 2 * tq + (r & 1);
      hs[mt][r] = (init && row < p.P && col < p.N) ? init[row * p.N + col] : 0.f;
    }
  if (owns_state) write_state_terms(hterm, hs, PW, n0, g, tq);
  const int a_off = tc::a_offset<kTcLd>(lane);
  const int b_off = tc::b_offset<kTcLd>(lane);
  const int x2_off = (lane & 15) * kTcLd;  // ldmatrix_x2_trans: rows 0 .. 15 of an 8-wide block
  const int pair = warp >> 1;  // the strip pair of y
  const int half = warp & 1;   // the half of P of y

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * p.L;
    const int len = min(p.L, p.S - t0);
    // chunk c's x, B, C and dt (every warp has read chunk c - 1's: the
    // barrier before the state's update)
    tc_load_rows(xs, x + t0 * p.x_ss, p.x_ss, LP, PW, len, p.P);
    tc_load_rows(bs, Bp + t0 * p.b_ss, p.b_ss, LP, NW, len, p.N);
    tc_load_rows(cs, Cp + t0 * p.c_ss, p.c_ss, LP, NW, len, p.N);
    for (int t = tid; t < LP; t += kTcThreads)
      cp_async_4(dts + t, t < len ? dt + (t0 + t) * p.dt_ss : dt, t < len ? 4 : 0);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; the state's terms are written

    if (warp == 0) {
      // 1. inclusive cumsum of dt * A over LP <= 128 steps: 4 consecutive steps a lane
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        run += t < LP ? dts[t] * a_h : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        if (t < LP) {
          const float cv = before + v[k];
          cum[t] = cv;
          ecum[t] = expf(cv);
          wdt[t] = expf(last - cv) * dts[t];
        }
      }
    }
    __syncthreads();

    const int LT = (len + 15) / 16;  // strips holding the chunk's steps
    const bool state_in = p.init != nullptr || c > 0;

    // 2. y of strips `pair` and LT - 1 - pair, P columns [32 half, +32)
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int i = pass == 0 ? pair : LT - 1 - pair;
      if (i >= LT || (pass == 1 && i < kTcThreads / 64)) continue;
      const int r0 = i * 16;
      uint32_t ca[kTcWidth / 16][4];  // A fragments of the strip's C, by 16-deep slice of N
#pragma unroll
      for (int kn = 0; kn < kTcWidth / 16; ++kn)
        if (kn * 16 < NW) tc::ldmatrix_x4(ca[kn], cs + r0 * kTcLd + kn * 16 + a_off);
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
      if (state_in) {
        // exp(cum_t) C h_in^T, h_in as three bf16 terms
#pragma unroll
        for (int kn = 0; kn < kTcWidth / 16; ++kn) {
          if (kn * 16 >= NW) continue;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int p0 = half * 32 + jj * 16;
            if (p0 >= PW) continue;
#pragma unroll
            for (int term = 0; term < 3; ++term) {
              uint32_t hb[4];  // b0, b1 of P columns p0 .. +7, then p0 + 8 .. +15
              tc::ldmatrix_x4(hb, hterm + term * kTcWidth * kTcLd + p0 * kTcLd + kn * 16 + b_off);
              tc::mma_16816(acc[2 * jj], ca[kn], hb[0], hb[1]);
              tc::mma_16816(acc[2 * jj + 1], ca[kn], hb[2], hb[3]);
            }
          }
        }
        const float e0 = ecum[r0 + g], e1 = ecum[r0 + g + 8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }
      const int ta = r0 + g, tb = r0 + g + 8;
      const float cum_a = cum[ta], cum_b = cum[tb];
#pragma unroll 1
      for (int jb = 0; jb <= i; ++jb) {
        const int s0 = jb * 16;
        float cb[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) cb[n][r] = 0.f;
#pragma unroll
        for (int kn = 0; kn < kTcWidth / 16; ++kn) {
          if (kn * 16 >= NW) continue;
          uint32_t bb[4];
          tc::ldmatrix_x4(bb, bs + s0 * kTcLd + kn * 16 + b_off);
          tc::mma_16816(cb[0], ca[kn], bb[0], bb[1]);
          tc::mma_16816(cb[1], ca[kn], bb[2], bb[3]);
        }
        // M' on the fragment, split into the A fragments of M' X: a0 / a1 rows
        // g / g + 8 of columns 0-7, a2 / a3 of columns 8-15
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int s = s0 + n * 8 + 2 * tq;
          const float cs0 = cum[s], cs1 = cum[s + 1];
          const float d0 = dts[s], d1 = dts[s + 1];
          const float m00 = s <= ta ? expf(cum_a - cs0) * d0 * cb[n][0] : 0.f;
          const float m01 = s + 1 <= ta ? expf(cum_a - cs1) * d1 * cb[n][1] : 0.f;
          const float m10 = s <= tb ? expf(cum_b - cs0) * d0 * cb[n][2] : 0.f;
          const float m11 = s + 1 <= tb ? expf(cum_b - cs1) * d1 * cb[n][3] : 0.f;
          tc::split_bf16(m00, m01, mh[2 * n], ml[2 * n]);
          tc::split_bf16(m10, m11, mh[2 * n + 1], ml[2 * n + 1]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int p0 = half * 32 + jj * 16;
          if (p0 >= PW) continue;
          uint32_t xb[4];
          tc::ldmatrix_x4_trans(xb, xs + s0 * kTcLd + p0 + a_off);
          tc::mma_16816(acc[2 * jj], mh, xb[0], xb[1]);
          tc::mma_16816(acc[2 * jj + 1], mh, xb[2], xb[3]);
          tc::mma_16816(acc[2 * jj], ml, xb[0], xb[1]);
          tc::mma_16816(acc[2 * jj + 1], ml, xb[2], xb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pc = half * 32 + j * 8 + 2 * tq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int t = r0 + g + 8 * rr;
          if (t >= len) continue;
          float* yr = y + (long long)(t0 + t) * y_ss;
          if (pc < p.P) yr[pc] = acc[j][2 * rr];
          if (pc + 1 < p.P) yr[pc + 1] = acc[j][2 * rr + 1];
        }
      }
    }

    // 3. the state's product X^T (w dt B) for this warp's N columns
    float hacc[kTcWidth / 16][4];
#pragma unroll
    for (int mt = 0; mt < kTcWidth / 16; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) hacc[mt][r] = 0.f;
    if (owns_state) {
#pragma unroll 1
      for (int ks = 0; ks < LT; ++ks) {
        const int s0 = ks * 16;
        uint32_t bb[2], bt[3][2];  // b0 (depth rows 2 tq, +1), b1 (rows 2 tq + 8, +9) of B
        tc::ldmatrix_x2_trans(bb, bs + s0 * kTcLd + n0 + x2_off);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb[r]));
          const int s = s0 + 2 * tq + 8 * r;
          tc::split3_bf16(v.x * wdt[s], v.y * wdt[s + 1], bt[0][r], bt[1][r], bt[2][r]);
        }
#pragma unroll
        for (int mt = 0; mt < kTcWidth / 16; ++mt) {
          if (mt * 16 >= PW) continue;
          uint32_t xa[4];  // A fragment of X^T: rows p, depth s
          tc::ldmatrix_x4_trans(xa, xs + s0 * kTcLd + mt * 16 + b_off);
#pragma unroll
          for (int term = 0; term < 3; ++term)
            tc::mma_16816(hacc[mt], xa, bt[term][0], bt[term][1]);
        }
      }
    }
    __syncthreads();  // every warp has read h_in's terms
    if (owns_state) {
      const float decay = ecum[LP - 1];
#pragma unroll
      for (int mt = 0; mt < kTcWidth / 16; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) hs[mt][r] = decay * hs[mt][r] + hacc[mt][r];
      write_state_terms(hterm, hs, PW, n0, g, tq);
    }
  }
  if (owns_state) {
    float* fin = p.final_state + ((long long)b * p.H + h) * p.P * p.N;
#pragma unroll
    for (int mt = 0; mt < kTcWidth / 16; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = mt * 16 + g + 8 * (r >> 1), col = n0 + 2 * tq + (r & 1);
        if (row < p.P && col < p.N) fin[row * p.N + col] = hs[mt][r];
      }
  }
}

template <int MT>
int launch(const Params& p, int Bsz, int smem, cudaStream_t stream) {
  auto kernel = ssd_kernel<MT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.H, Bsz), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const Params& p, int Bsz, int smem, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(ssd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_tc_kernel<<<dim3(p.H, Bsz), kTcThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory in bytes a block of the kernel for `dtype` (0:
// float32, the CUDA-core kernel; 1: bfloat16, the tensor-core kernel) takes
// at chunk length L and widths P, N, or -1 where that kernel does not take
// them (L outside [1, 128]; P or N outside [1, 128] for float32, [1, 64] for
// bfloat16; more shared memory than a block may have).
extern "C" int ssd_smem_bytes(int L, int P, int N, int dtype) {
  if (L < 1 || P < 1 || N < 1 || L > 16 * kMaxTiles) return -1;
  long long bytes;
  if (dtype == 0) {
    if (P > 16 * kMaxTiles || N > 16 * kMaxTiles) return -1;
    bytes = 4LL * smem_floats(L, P, N);
  } else if (dtype == 1) {
    if (P > kTcWidth || N > kTcWidth) return -1;
    bytes = tc_smem_bytes(L);
  } else {
    return -1;
  }
  return bytes <= 232448 ? static_cast<int>(bytes) : -1;
}

// Launches the kernel on `stream` and returns a cudaError_t as an int (0 on
// success).  `x`, `B`, `C` are device pointers of one type (`dtype` 0:
// float32, the CUDA-core kernel; 1: bfloat16, the tensor-core kernel), `dt`,
// `A`, `init` (may be null), `y`, `final_state` float32; y [Bsz, S, H, P] and
// final_state [Bsz, H, P, N] contiguous, `init` [Bsz, H, P, N] contiguous.
// Strides are in elements: (batch, step, head) for x and dt, (batch, step,
// group) for B and C, whose last dimension is contiguous.  The caller
// guarantees Bsz, S, H >= 1, G dividing H, 1 <= L <= S, ssd_smem_bytes(L, P,
// N, dtype) > 0 and, for bfloat16, 16-byte aligned x, B, C whose strides are
// multiples of 8.
extern "C" int ssd_launch(const void* x, const void* B, const void* C, int dtype,
                          const float* dt, const float* A, const float* init, float* y,
                          float* final_state, int Bsz, int S, int H, int G, int P, int N, int L,
                          long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                          long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
                          long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                          void* stream) {
  const int smem = ssd_smem_bytes(L, P, N, dtype);
  if (smem < 0 || Bsz < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || L > S)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.B = B;
  p.C = C;
  p.dt = dt;
  p.A = A;
  p.init = init;
  p.y = y;
  p.final_state = final_state;
  p.S = S;
  p.H = H;
  p.rep = H / G;
  p.P = P;
  p.N = N;
  p.L = L;
  p.x_sb = x_sb;
  p.x_ss = x_ss;
  p.x_sh = x_sh;
  p.dt_sb = dt_sb;
  p.dt_ss = dt_ss;
  p.dt_sh = dt_sh;
  p.b_sb = b_sb;
  p.b_ss = b_ss;
  p.b_sg = b_sg;
  p.c_sb = c_sb;
  p.c_ss = c_ss;
  p.c_sg = c_sg;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_tc(p, Bsz, smem, s);
  return P > 64 || N > 64 ? launch<8>(p, Bsz, smem, s) : launch<4>(p, Bsz, smem, s);
}
