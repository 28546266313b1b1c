// sLSTM recurrence kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/slstm.py::slstm_kernel, the Pallas TPU kernel
// that slstm_scan launches through pl.pallas_call.
//
// Computes what the reference's model computes (repro/models/ssm_xlstm.py::
// _slstm_scan), in float32.  For t = 0 .. S-1, per batch row b, head h and
// output dim e, with a_g = u[b, t, g d + h D + e] + sum_k h_{t-1}[b, h, k]
// R[g, h, k, e] for the gates g = z, i, f, o:
//   z = tanh(a_z), o = 1 / (1 + exp(-a_o)), i = a_i, f = a_f
//   m' = max(f + m, i), i~ = exp(i - m'), f~ = exp(f + m - m')
//   c' = f~ c + i~ z,   n' = max(f~ n + i~, exp(-m')),   h' = o c' / n'
// Beside the TPU kernel (u as [S, B, 4, H, D], a zero initial state with m =
// -1e30) this takes the model's [B, S, 4 d] pre-activations through their
// element strides (float32 or bfloat16, the last dimension contiguous), an
// initial state (c, n, h, m) [B, H, D] in float32, and any S >= 1.  It
// writes h_seq [B, S, d] and the final state in float32 and, for the
// written-out backward, optionally the per-step c, n and m as [B, S, d].
//
// Bound on this card.  Every step reads all of R [4, H, D, D] and waits on
// the previous step's h.  At xlstm-1.3b's sLSTM (H 4, D 512, d 2048), B 8,
// S 2048: 2 S B 4 H D^2 = 137 GFLOP of float32 FMA, 2.05 ms at 67 TFLOP/s,
// against about 0.42 GB of bytes (u in bfloat16, h_seq in float32, R once),
// 0.13 ms: the operations bound it.  The sequence adds a floor of its own:
// S grid-wide exchanges of h, each at least about a microsecond.  At decode
// (S = 1) R's 16.8 MB read once bound it: 5.0 us.
//
// Design: R resident in shared memory across a cooperative grid.  R (16.8
// MB) fits neither one SM's 227 KB nor a cluster's, but it fits the card's
// combined shared memory.  So one persistent block per SM is launched with
// cudaLaunchCooperativeKernel (which launches only if every block is
// resident at once), and block j owns head h = j / (D / E) and the E output
// dims e0 .. e0 + E - 1 of all four gates: at D = 512, E = 16, 4 heads x 32
// blocks = 128 blocks, each holding its 4 x 512 x 16 float32 columns of R
// (128 KB) in shared memory for the whole run.  Its slice of the state (c,
// n, m, h for its dims, every batch row) stays in shared memory too.  Per
// step a block:
//   1. stages its head's previous h ([B, D] float32, batch rows in tiles of
//      8, read from L2 with __ldcg) and the tile's u for its dims;
//   2. computes its 4 E columns of h @ R for the tile: thread (column c,
//      part p) sums k = p, p + P, ... < D into 8 float32 accumulators, one
//      per batch row, reading R[k][c] (consecutive threads, consecutive
//      columns) and h[k][0..7] (two broadcast 16-byte loads);
//   3. adds the P partial sums in a fixed order and updates the gates and
//      the state of its dims, writing h to h_seq and to a double-buffered
//      [2, B, H, D] scratch that the next step reads;
//   4. meets the other blocks at a grid-wide barrier: a monotonic counter
//      (atomicAdd, then a spin on an acquire load until it reaches (t + 1)
//      x blocks), one barrier a step.  The double buffer makes one barrier
//      enough: step t + 1 writes the buffer step t read only after every
//      block has passed barrier t.
// E is the smallest divisor of D whose H D / E blocks fit one to an SM; where
// none does the wrapper raises, naming the shape.  The products stay in
// float32 on the CUDA cores, as the reference computes them (TF32 or bf16
// tensor-core products would change the numbers).  No fast math: expf,
// tanhf and IEEE division; max as jnp.maximum (a NaN wins).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 8;  // batch rows a tile: the accumulators a thread keeps

struct Params {
  const void* u;
  long long u_sb, u_ss;  // element strides of u's batch and step dimensions
  const float* R;        // [4, H, D, D]
  const float* c0;
  const float* n0;
  const float* h0;
  const float* m0;       // [B, H, D]
  float* h_seq;          // [B, S, d]
  float* c_seq;          // [B, S, d] or null (with n_seq, m_seq)
  float* n_seq;
  float* m_seq;
  float* c_out;
  float* n_out;
  float* h_out;
  float* m_out;          // [B, H, D]
  float* hbuf;           // [2, B, H, D] scratch
  unsigned int* counter; // zero at launch
  int B, S, H, D, E, P;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// jnp.maximum: a NaN in either argument is the result
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives, then waits until all have: the counter
// counts arrivals over the whole run, so barrier t waits for (t + 1) x grid.
__device__ __forceinline__ void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's writes of h are visible before it arrives
    atomicAdd(counter, 1u);
    while (load_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Columns c = g E + e of a block, and the parts P of the k sum.
__host__ __device__ inline int parts(int D, int E) {
  const int ncol = 4 * E;
  int P = ncol >= kThreads ? 1 : kThreads / ncol;
  return P < D ? P : D;
}

// Shared memory of one block, in floats.
__host__ __device__ inline long long smem_floats(int B, int D, int E) {
  const long long ncol = 4LL * E;
  return (long long)D * kBT          // h tile [D][kBT]
         + (long long)D * ncol       // R slice [D][4E]
         + (long long)kBT * parts(D, E) * ncol  // partial sums [kBT][P][4E]
         + (long long)kBT * ncol     // u tile [kBT][4][E]
         + 4LL * B * E;              // state c, n, m, h [B][E]
}

template <typename T>
__global__ void __launch_bounds__(kThreads) slstm_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, E = p.E, P = p.P, H = p.H, B = p.B;
  const int ncol = 4 * E;
  const int dm = H * D;
  float* hs = smem;                  // [D][kBT]
  float* rs = hs + D * kBT;          // [D][ncol]
  float* ps = rs + D * ncol;         // [kBT][P][ncol]
  float* us = ps + kBT * P * ncol;   // [kBT][4][E]
  float* cs = us + kBT * ncol;       // [B][E]
  float* ns = cs + B * E;
  float* ms = ns + B * E;
  float* hl = ms + B * E;            // the last h of each (b, e)

  const int tid = threadIdx.x;
  const int head = blockIdx.x / (D / E);
  const int e0 = (blockIdx.x % (D / E)) * E;

  // the block's columns of R, and its slice of the initial state
  for (int i = tid; i < D * ncol; i += kThreads) {
    const int k = i / ncol, c = i % ncol, g = c / E, e = c % E;
    rs[i] = p.R[(((long long)g * H + head) * D + k) * D + e0 + e];
  }
  for (int i = tid; i < B * E; i += kThreads) {
    const int b = i / E, e = i % E;
    const long long s = ((long long)b * H + head) * D + e0 + e;
    cs[i] = p.c0[s];
    ns[i] = p.n0[s];
    ms[i] = p.m0[s];
    hl[i] = p.h0[s];
  }
  const T* u = static_cast<const T*>(p.u);
  const long long plane = (long long)B * dm;  // one buffer of hbuf

  for (int t = 0; t < p.S; ++t) {
    const float* hsrc = t == 0 ? p.h0 : p.hbuf + (t & 1) * plane;
    float* hdst = p.hbuf + ((t + 1) & 1) * plane;
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int bt = min(kBT, B - b0);
      __syncthreads();  // the previous tile is consumed (and the state loaded)
      // 1. the tile's previous h (zero past the batch) and its u
      for (int i = tid; i < kBT * D; i += kThreads) {
        const int b = i / D, k = i % D;
        float v = 0.f;
        if (b < bt) {
          const float* src = hsrc + ((long long)(b0 + b) * H + head) * D + k;
          v = t == 0 ? *src : __ldcg(src);
        }
        hs[k * kBT + b] = v;
      }
      for (int i = tid; i < bt * ncol; i += kThreads) {
        const int b = i / ncol, c = i % ncol, g = c / E, e = c % E;
        us[i] = to_f32(u[(b0 + b) * p.u_sb + t * p.u_ss + (long long)g * dm + head * D + e0 + e]);
      }
      __syncthreads();
      // 2. partial sums of h @ R: item (column c, part q)
      for (int it = tid; it < ncol * P; it += kThreads) {
        const int c = it % ncol, q = it / ncol;
        float acc[kBT];
#pragma unroll
        for (int b = 0; b < kBT; ++b) acc[b] = 0.f;
        for (int k = q; k < D; k += P) {
          const float r = rs[k * ncol + c];
          const float4 h_lo = reinterpret_cast<const float4*>(hs + k * kBT)[0];
          const float4 h_hi = reinterpret_cast<const float4*>(hs + k * kBT)[1];
          acc[0] = fmaf(h_lo.x, r, acc[0]);
          acc[1] = fmaf(h_lo.y, r, acc[1]);
          acc[2] = fmaf(h_lo.z, r, acc[2]);
          acc[3] = fmaf(h_lo.w, r, acc[3]);
          acc[4] = fmaf(h_hi.x, r, acc[4]);
          acc[5] = fmaf(h_hi.y, r, acc[5]);
          acc[6] = fmaf(h_hi.z, r, acc[6]);
          acc[7] = fmaf(h_hi.w, r, acc[7]);
        }
#pragma unroll
        for (int b = 0; b < kBT; ++b) ps[(b * P + q) * ncol + c] = acc[b];
      }
      __syncthreads();
      // 3. the gates and the state of item (b, e)
      for (int it = tid; it < bt * E; it += kThreads) {
        const int b = it / E, e = it % E;
        float a[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int c = g * E + e;
          float rec = 0.f;
          for (int q = 0; q < P; ++q) rec += ps[(b * P + q) * ncol + c];
          a[g] = us[b * ncol + c] + rec;
        }
        const int sidx = (b0 + b) * E + e;
        const float z = tanhf(a[0]);
        const float ig = a[1];
        const float fg = a[2];
        const float o = 1.f / (1.f + expf(-a[3]));
        const float c = cs[sidx], n = ns[sidx], m = ms[sidx];
        const float m_new = jmax(fg + m, ig);
        const float i_ = expf(ig - m_new);
        const float f_ = expf(fg + m - m_new);
        const float c_new = f_ * c + i_ * z;
        const float n_new = jmax(f_ * n + i_, expf(-m_new));
        const float h_new = o * c_new / n_new;
        cs[sidx] = c_new;
        ns[sidx] = n_new;
        ms[sidx] = m_new;
        hl[sidx] = h_new;
        const long long col = (long long)head * D + e0 + e;
        const long long o_idx = ((long long)(b0 + b) * p.S + t) * dm + col;
        p.h_seq[o_idx] = h_new;
        if (p.c_seq) {
          p.c_seq[o_idx] = c_new;
          p.n_seq[o_idx] = n_new;
          p.m_seq[o_idx] = m_new;
        }
        __stcg(hdst + (long long)(b0 + b) * dm + col, h_new);
      }
    }
    if (t + 1 < p.S) grid_barrier(p.counter, (unsigned int)(t + 1) * gridDim.x);
  }
  __syncthreads();
  for (int i = tid; i < B * E; i += kThreads) {
    const int b = i / E, e = i % E;
    const long long s = ((long long)b * H + head) * D + e0 + e;
    p.c_out[s] = cs[i];
    p.n_out[s] = ns[i];
    p.m_out[s] = ms[i];
    p.h_out[s] = hl[i];
  }
}

template <typename T>
int occupancy(int smem, int* blocks_per_sm) {
  auto kernel = slstm_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem));
}

}  // namespace

// The launch plan for B batch rows, H heads of D dims and u's dtype (0:
// float32, 1: bfloat16): out[0] = E (output dims a block), out[1] = blocks,
// out[2] = dynamic shared memory in bytes, out[3] = the card's SMs.  E is
// the smallest divisor of D whose H D / E blocks each fit alone on an SM.
// Returns 0, a cudaError_t as an int, or -1 where no E fits (R's slices or
// the state too large for the card's shared memory).
extern "C" int slstm_plan(int Bsz, int H, int D, int dtype, int* out) {
  if (Bsz < 1 || H < 1 || D < 1 || (dtype != 0 && dtype != 1)) return -1;
  int dev = 0, sms = 0, coop = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  for (int E = 1; E <= D; ++E) {
    if (D % E) continue;
    const long long blocks = (long long)H * (D / E);
    const long long bytes = 4 * smem_floats(Bsz, D, E);
    if (blocks > sms || bytes > max_smem) continue;
    int per_sm = 0;
    const int rc = dtype == 0 ? occupancy<float>((int)bytes, &per_sm)
                              : occupancy<__nv_bfloat16>((int)bytes, &per_sm);
    if (rc != 0) return rc;
    if (per_sm < 1) continue;
    out[0] = E;
    out[1] = (int)blocks;
    out[2] = (int)bytes;
    out[3] = sms;
    return 0;
  }
  return -1;
}

// Launches the kernel cooperatively on `stream` with E from slstm_plan and
// returns a cudaError_t as an int (0 on success).  `u` [Bsz, S, 4 H D] of
// `dtype` (0: float32, 1: bfloat16) with element strides (u_sb, u_ss) and a
// contiguous last dimension; R [4, H, D, D], the initial and final states
// [Bsz, H, D], h_seq and the optional per-step c_seq / n_seq / m_seq (all
// three or none) [Bsz, S, H D], hbuf [2, Bsz, H, D] float32 and contiguous;
// `counter` one unsigned int, zero.
extern "C" int slstm_launch(const void* u, int dtype, long long u_sb, long long u_ss,
                            const float* R, const float* c0, const float* n0, const float* h0,
                            const float* m0, float* h_seq, float* c_seq, float* n_seq,
                            float* m_seq, float* c_out, float* n_out, float* h_out, float* m_out,
                            float* hbuf, unsigned int* counter, int Bsz, int S, int H, int D,
                            int E, void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || D < 1 || E < 1 || D % E != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.u = u;
  p.u_sb = u_sb;
  p.u_ss = u_ss;
  p.R = R;
  p.c0 = c0;
  p.n0 = n0;
  p.h0 = h0;
  p.m0 = m0;
  p.h_seq = h_seq;
  p.c_seq = c_seq;
  p.n_seq = n_seq;
  p.m_seq = m_seq;
  p.c_out = c_out;
  p.n_out = n_out;
  p.h_out = h_out;
  p.m_out = m_out;
  p.hbuf = hbuf;
  p.counter = counter;
  p.B = Bsz;
  p.S = S;
  p.H = H;
  p.D = D;
  p.E = E;
  p.P = parts(D, E);
  const long long bytes = 4 * smem_floats(Bsz, D, E);
  const int blocks = H * (D / E);
  if (bytes > 232448 || (long long)S * blocks >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (int)bytes;
  void* args[] = {&p};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(slstm_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaLaunchCooperativeKernel((const void*)slstm_kernel<float>, dim3(blocks),
                                        dim3(kThreads), args, smem, s);
  } else {
    err = cudaFuncSetAttribute(slstm_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaLaunchCooperativeKernel((const void*)slstm_kernel<__nv_bfloat16>, dim3(blocks),
                                        dim3(kThreads), args, smem, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
