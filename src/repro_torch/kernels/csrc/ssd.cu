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
// Design.  The TPU kernel walks a (batch*head, chunk) grid whose chunk axis
// runs in order, carrying the state in VMEM scratch from one chunk to the
// next.  CUDA blocks run in no order, so here one block of 256 threads owns
// one (batch, head) and loops over the chunks itself, the state [P, N] in
// shared memory for the whole loop.  Per chunk:
//   1. dt is staged; warp 0 takes the inclusive cumsum of dt * A with warp
//      shuffles (steps past the sequence's end get dt = 0: they leave the
//      state as it is), then exp(cum_t) and exp(cum_last - cum_t);
//   2. u = x * dt, B and C of the head's group are staged in shared memory as
//      float32 (cast on load, as the TPU kernel casts);
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
// zeros to multiples of 16 rows and columns.  At zamba2's L = 128, P = N = 64
// a block takes 179 KB of shared memory, so one block runs per SM.
//
// Bound on this card.  The function needs, per chunk and per (batch, head),
// (2 N + 2 P) FLOPs for each of the L (L + 1) / 2 pairs s <= t (C_t . B_s
// and M u) and 4 L P N for the state's read into y and its update; x, dt,
// B, C are read once and y and the state written once.  At zamba2's prefill
// (B = 8, S = 2048, H = 64, P = N = 64, L = 128, an initial state) that is
// 3.4e10 FLOPs against 0.43 GB, so the operations bound it: 0.51 ms at the
// 67 TFLOP/s float32 rate (the reference computes the scan in float32).
// This first kernel runs on the CUDA cores, its inner loops bound by
// shared-memory loads, and spends FMAs on the masked upper triangle of M
// too; tensor cores (tf32 or bf16 mma for C B^T and M U), skipping the upper
// triangle's tiles and one block for several heads of a group are the next
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of one block, in floats, for chunk length L and widths P, N.
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
template <typename T, int MT>
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

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* Bp = static_cast<const T*>(p.B) + b * p.b_sb + g * p.b_sg;
  const T* Cp = static_cast<const T*>(p.C) + b * p.c_sb + g * p.c_sg;
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
            (t < len && c < p.P) ? to_f32(x[(t0 + t) * p.x_ss + c]) * dt_s[t] : 0.f;
      }
      for (int i = tid - 32; i < LP * NP; i += kThreads - 32) {
        const int t = i / NP, c = i % NP;
        const bool in = t < len && c < p.N;
        b_s[t * BS + c] = in ? to_f32(Bp[(t0 + t) * p.b_ss + c]) : 0.f;
        c_s[t * BS + c] = in ? to_f32(Cp[(t0 + t) * p.c_ss + c]) : 0.f;
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

template <typename T, int MT>
int launch(const Params& p, int Bsz, int smem, cudaStream_t stream) {
  auto kernel = ssd_kernel<T, MT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.H, Bsz), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory in bytes a block takes at chunk length L and widths
// P, N, or -1 where the kernel does not take them (L, P or N outside [1,
// 128], or more shared memory than a block may have).
extern "C" int ssd_smem_bytes(int L, int P, int N) {
  if (L < 1 || P < 1 || N < 1 || L > 16 * kMaxTiles || P > 16 * kMaxTiles ||
      N > 16 * kMaxTiles)
    return -1;
  const long long bytes = 4LL * smem_floats(L, P, N);
  return bytes <= 232448 ? static_cast<int>(bytes) : -1;
}

// Launches the kernel on `stream` and returns a cudaError_t as an int (0 on
// success).  `x`, `B`, `C` are device pointers of one type (`dtype` 0:
// float32, 1: bfloat16), `dt`, `A`, `init` (may be null), `y`, `final_state`
// float32; y [Bsz, S, H, P] and final_state [Bsz, H, P, N] contiguous, `init`
// [Bsz, H, P, N] contiguous.  Strides are in elements: (batch, step, head)
// for x and dt, (batch, step, group) for B and C, whose last dimension is
// contiguous.  The caller guarantees Bsz, S, H >= 1, G dividing H, 1 <= L <=
// S and ssd_smem_bytes(L, P, N) > 0.
extern "C" int ssd_launch(const void* x, const void* B, const void* C, int dtype,
                          const float* dt, const float* A, const float* init, float* y,
                          float* final_state, int Bsz, int S, int H, int G, int P, int N, int L,
                          long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                          long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
                          long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                          void* stream) {
  const int smem = ssd_smem_bytes(L, P, N);
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
  const bool wide = P > 64 || N > 64;
  if (dtype == 0) return wide ? launch<float, 8>(p, Bsz, smem, s) : launch<float, 4>(p, Bsz, smem, s);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, 8>(p, Bsz, smem, s)
                : launch<__nv_bfloat16, 4>(p, Bsz, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
