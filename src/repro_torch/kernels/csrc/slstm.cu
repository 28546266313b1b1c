// sLSTM recurrence kernels for Hopper (sm_90a).
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
// S exchanges of h between the blocks of a head, each at least an L2 round
// trip.  At decode (S = 1) R's 16.8 MB read once bound it: 5.0 us.
//
// Design: R resident in registers across a cooperative grid.  R (16.8 MB)
// fits neither one SM nor a cluster, but it fits the card's combined
// register files.  Block j owns head h = j / (D / E) and the E output dims
// e0 .. e0 + E - 1 of all four gates, 4 E columns of R; its 256 threads are
// 2 E column pairs x Q = 128 / E parts of the k sum, each part KP = D / Q
// consecutive k.  A thread keeps its two columns' KP values of R in
// registers for the whole run: at D = 512, E = 16, that is 2 x 64 floats a
// thread, 128 KB a block, 4 heads x 32 blocks = 128 blocks, one an SM.  The
// block's slice of the state (c, n, m, h for its dims, every batch row)
// stays in shared memory.  Per step and tile of 8 batch rows a block:
//   1. stages its head's h_{t-1} [8, D] into shared memory (k-major, so the
//      products read 8 batch rows as two broadcast 16-byte loads), each
//      thread's loads of two words at a time all in flight together, then
//      the tile's u from registers and the next tile's u into them (their
//      loads overlap the products);
//   2. computes its partial sums of h @ R: 8 rows x 2 columns, KP float32
//      FMAs each in k order, R from registers;
//   3. adds the Q partial sums of each column in part order (a fixed
//      order: two calls give equal bits) and updates the gates and the
//      state of item (b, e), writing h to h_seq and to the exchange buffer.
// The exchange is per head: a head's gates read only that head's h, so a
// block waits on the D / E blocks of its own head, never on the grid.  Each
// h goes out as one 64-bit word {step + 1, h's bits} (one store, so a
// reader sees both halves or neither) into a double-buffered [2, B, H, D]
// buffer that is zero at launch; a reader loads its words, and loads again
// those whose step tag is not yet the one it wants.  No barrier, no counter
// and no fence stand between a step's h and the next step's products: the
// data carries its own flag.  The double buffer is enough: a block writes
// step t + 2's words over step t's only after reading step t + 1's words
// from every block of its head, each written after that block had read
// step t's.  The cooperative launch refuses to run unless every block is
// resident, which the waiting needs.
//
// Decode (S = 1) runs the same step as a kernel of its own, launched
// without the cooperative launch: no exchange, no scratch, R read from
// global memory (16.8 MB stays in the 50 MB L2 from one decode step to the
// next) into the same registers, the same partial sums in the same order,
// so it gives the scan's first step bit for bit.
//
// Measured on an H100 (700 W) at 8 x 2048 (PERF.md): about 5 us a
// step, of which 2.6 the exchange (the loads' latency, not waiting on
// late blocks), 1.65 the products and 0.75 the gates.
//
// E is the smallest power of two from 2 to 32 that divides D (so D is even)
// with at most 64 k a part and H D / E blocks that fit one to an SM; where
// none does the wrapper raises, naming the shape.  The products stay in
// float32 on the CUDA cores, as the reference computes them (TF32 or bf16
// tensor-core products would change the numbers).  No fast math: expf,
// tanhf and IEEE division; max as jnp.maximum (a NaN wins).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 8;      // batch rows a tile: the accumulators of a column
constexpr int kMaxKP = 64;  // R values a thread keeps for each of its columns
constexpr int kMaxE = 32;   // output dims a block
constexpr int kMaxNU = kBT * 4 * kMaxE / kThreads;  // u values a thread prefetches
constexpr int kHP = 8;      // h word pairs a thread has in flight while staging

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
  unsigned long long* hx;  // [2, B, H, D] {step + 1, h bits}, zero at launch; null at S = 1
  int B, S, H, D, E;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// jnp.maximum: a NaN in either argument is the result
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }

// two words of 16-byte aligned memory in one access (each word single-copy
// atomic on its own, which is all the step tags need)
__device__ __forceinline__ ulonglong2 ld_relaxed2(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// The parts Q of the k sum and the k a part, for E dims a block.
__host__ __device__ inline int n_parts(int E) { return kThreads / (2 * E); }
__host__ __device__ inline int part_len(int D, int E) {
  const int Q = n_parts(E);
  return (D + Q - 1) / Q;
}

// Shared memory of one block, in floats.
__host__ __device__ inline long long smem_floats(int B, int D, int E) {
  const long long ncol = 4LL * E;
  return (long long)D * kBT                    // h tile [D][kBT]
         + (long long)n_parts(E) * kBT * ncol  // partial sums [Q][kBT][4E]
         + (long long)kBT * ncol               // u tile [kBT][4E]
         + 4LL * B * E;                        // state c, n, m, h [B][E]
}

// The partial sums of one part of the k sum for two columns and kBT rows:
// a0[b] = sum_i h[i][b] r0[i] over the part's kn k in order, one FMA chain
// from zero each (kFull: all kMaxKP of them, no bound checks).
template <bool kFull>
__device__ __forceinline__ void part_sums(const float* hs, int kn, const float (&r0)[kMaxKP],
                                          const float (&r1)[kMaxKP], float (&a0)[kBT],
                                          float (&a1)[kBT]) {
#pragma unroll
  for (int b = 0; b < kBT; ++b) a0[b] = a1[b] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxKP; ++i) {
    if (kFull || i < kn) {
      const float4 h_lo = reinterpret_cast<const float4*>(hs + i * kBT)[0];
      const float4 h_hi = reinterpret_cast<const float4*>(hs + i * kBT)[1];
      const float h8[kBT] = {h_lo.x, h_lo.y, h_lo.z, h_lo.w, h_hi.x, h_hi.y, h_hi.z, h_hi.w};
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        a0[b] = fmaf(h8[b], r0[i], a0[b]);
        a1[b] = fmaf(h8[b], r1[i], a1[b]);
      }
    }
  }
}

// Loads into `upf` the u values of tile `tile` of step `t` that this thread
// stages: item i = j kThreads + tid is (row i / 4E, column i % 4E).
template <typename T>
__device__ __forceinline__ void load_u(const Params& p, const T* u, int t, int tile, int head,
                                       int e0, T (&upf)[kMaxNU]) {
  const int E = p.E, ncol = 4 * E, dm = p.H * p.D;
  const int b0 = tile * kBT, bt = min(kBT, p.B - b0);
#pragma unroll
  for (int j = 0; j < kMaxNU; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int b = i / ncol, c = i % ncol;
    if (b < bt) {
      upf[j] = u[(b0 + b) * p.u_sb + t * p.u_ss + (long long)(c / E) * dm + head * p.D + e0 +
                 c % E];
    }
  }
}

template <typename T, bool kScan>
__global__ void __launch_bounds__(kThreads, 1) slstm_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, E = p.E, H = p.H, B = p.B;
  const int S = kScan ? p.S : 1;
  const int Q = n_parts(E), KP = part_len(D, E);
  const int ncol = 4 * E;
  const int dm = H * D;
  float* hs = smem;                  // [D][kBT]
  float* ps = hs + D * kBT;          // [Q][kBT][ncol]
  float* us = ps + Q * kBT * ncol;   // [kBT][ncol]
  float* cs = us + kBT * ncol;       // [B][E]
  float* ns = cs + B * E;
  float* ms = ns + B * E;
  float* hl = ms + B * E;            // the last h of each (b, e)

  const int tid = threadIdx.x;
  const int head = blockIdx.x / (D / E);
  const int e0 = (blockIdx.x % (D / E)) * E;

  // this thread's two columns and its part of the k sum
  const int pair = tid % (2 * E), q = tid / (2 * E);
  const int c0 = 2 * pair, c1 = c0 + 1;
  const int kbeg = q * KP;
  const int kn = max(0, min(KP, D - kbeg));
  float r0[kMaxKP], r1[kMaxKP];
  {
    const float* R0 = p.R + ((long long)((c0 / E) * H + head) * D + kbeg) * D + e0 + c0 % E;
    const float* R1 = p.R + ((long long)((c1 / E) * H + head) * D + kbeg) * D + e0 + c1 % E;
#pragma unroll
    for (int i = 0; i < kMaxKP; ++i) {
      r0[i] = i < kn ? __ldg(R0 + (long long)i * D) : 0.f;
      r1[i] = i < kn ? __ldg(R1 + (long long)i * D) : 0.f;
    }
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
  const int ntiles = (B + kBT - 1) / kBT;
  T upf[kMaxNU];  // the u values of the next tile this thread stages
  load_u(p, u, 0, 0, head, e0, upf);

  for (int t = 0; t < S; ++t) {
    for (int tile = 0; tile < ntiles; ++tile) {
      const int b0 = tile * kBT, bt = min(kBT, B - b0);
      __syncthreads();  // the previous tile is consumed (and the state loaded)
      // 1. h_{t-1} (the initial state's, or step t - 1's words once tagged
      //    t), then the tile's u from registers and the next tile's u into them
      const bool from_hx = kScan && t > 0;
      const unsigned long long* src = p.hx + (long long)((t - 1) & 1) * B * dm + head * D;
      const float* src0 = p.h0 + head * D;
      const unsigned int want = t;
      const int np = kBT * D / 2;  // word pairs (b, 2 kp), (b, 2 kp + 1): item kp kBT + b
      for (int base = 0; base < np; base += kThreads * kHP) {
        ulonglong2 v[kHP];
        unsigned int valid = 0;  // bit j: pair j is a row of the tile
#pragma unroll
        for (int j = 0; j < kHP; ++j) {
          const int i = base + j * kThreads + tid;
          if (i < np && i % kBT < bt) valid |= 1u << j;
        }
        if (!from_hx) {
          const unsigned long long tag = static_cast<unsigned long long>(want) << 32;
#pragma unroll
          for (int j = 0; j < kHP; ++j) {
            const int i = base + j * kThreads + tid;
            if (valid >> j & 1) {
              const float2 f = __ldg(reinterpret_cast<const float2*>(
                  src0 + (long long)(b0 + i % kBT) * dm + 2 * (i / kBT)));
              v[j] = make_ulonglong2(tag | __float_as_uint(f.x), tag | __float_as_uint(f.y));
            }
          }
        } else {
          // rounds: every pair not yet tagged t is loaded again, all at once
          unsigned int pending = valid;
          do {
#pragma unroll
            for (int j = 0; j < kHP; ++j) {
              const int i = base + j * kThreads + tid;
              if (pending >> j & 1)
                v[j] = ld_relaxed2(src + (long long)(b0 + i % kBT) * dm + 2 * (i / kBT));
            }
#pragma unroll
            for (int j = 0; j < kHP; ++j) {
              if ((pending >> j & 1) && static_cast<unsigned int>(v[j].x >> 32) == want &&
                  static_cast<unsigned int>(v[j].y >> 32) == want)
                pending &= ~(1u << j);
            }
          } while (pending);
        }
#pragma unroll
        for (int j = 0; j < kHP; ++j) {
          const int i = base + j * kThreads + tid;
          if (i < np) {
            const bool ok = valid >> j & 1;
            const int k = 2 * (i / kBT), b = i % kBT;
            hs[k * kBT + b] = ok ? __uint_as_float(static_cast<unsigned int>(v[j].x)) : 0.f;
            hs[(k + 1) * kBT + b] = ok ? __uint_as_float(static_cast<unsigned int>(v[j].y)) : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxNU; ++j) {
        const int i = j * kThreads + tid;
        if (i / ncol < bt) us[i] = to_f32(upf[j]);
      }
      if (tile + 1 < ntiles) {
        load_u(p, u, t, tile + 1, head, e0, upf);
      } else if (t + 1 < S) {
        load_u(p, u, t + 1, 0, head, e0, upf);
      }
      __syncthreads();
      // 2. partial sums of h @ R for the thread's two columns, k in order
      {
        float a0[kBT], a1[kBT];
        if (kn == kMaxKP) {
          part_sums<true>(hs + kbeg * kBT, kn, r0, r1, a0, a1);
        } else {
          part_sums<false>(hs + kbeg * kBT, kn, r0, r1, a0, a1);
        }
#pragma unroll
        for (int b = 0; b < kBT; ++b) {
          reinterpret_cast<float2*>(ps + (q * kBT + b) * ncol + c0)[0] = make_float2(a0[b], a1[b]);
        }
      }
      __syncthreads();
      // 3. the gates and the state of item (b, e)
      for (int it = tid; it < bt * E; it += kThreads) {
        const int b = it / E, e = it % E;
        // the parts in order for each gate, the four sums side by side
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        const float* part = ps + b * ncol + e;
#pragma unroll 8
        for (int qq = 0; qq < Q; ++qq) {
#pragma unroll
          for (int g = 0; g < 4; ++g) a[g] += part[qq * kBT * ncol + g * E];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) a[g] = us[b * ncol + g * E + e] + a[g];
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
        if (kScan && t + 1 < S) {
          st_relaxed(p.hx + (long long)(t & 1) * B * dm + (long long)(b0 + b) * dm + col,
                     (static_cast<unsigned long long>(t + 1) << 32) | __float_as_uint(h_new));
        }
      }
    }
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

// Both kernels of type T may take up to `limit` bytes of dynamic shared
// memory: the card's most, so that no plan (of any batch size) caps another.
template <typename T>
cudaError_t set_smem_limit(int limit) {
  cudaError_t err = cudaFuncSetAttribute(slstm_kernel<T, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(slstm_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  return err;
}

template <typename T>
int occupancy(int limit, int smem, int* blocks_per_sm) {
  cudaError_t err = set_smem_limit<T>(limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, slstm_kernel<T, true>, kThreads, smem));
}

template <typename T>
cudaError_t launch(const Params& p, int blocks, int smem, cudaStream_t s) {
  if (p.S == 1) {
    slstm_kernel<T, false><<<blocks, kThreads, smem, s>>>(p);
    return cudaSuccess;
  }
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchCooperativeKernel((const void*)slstm_kernel<T, true>, dim3(blocks),
                                     dim3(kThreads), args, smem, s);
}

}  // namespace

// The launch plan for B batch rows, H heads of D dims and u's dtype (0:
// float32, 1: bfloat16): out[0] = E (output dims a block), out[1] = blocks,
// out[2] = dynamic shared memory in bytes, out[3] = the card's SMs, out[4]
// = the parts Q of the k sum.  E is the smallest power of two from 2 to 32
// that divides D with at most 64 k a part and H D / E blocks that each fit
// alone on an SM.  Raises both kernels' shared-memory limit on the current
// device to the card's most, which slstm_launch then needs.  Returns 0, a cudaError_t as an int, or -1
// where no E fits (R's slices or the state too large for the card).
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
  for (int E = 2; E <= kMaxE; E *= 2) {
    if (D % E || part_len(D, E) > kMaxKP) continue;
    const long long blocks = (long long)H * (D / E);
    const long long bytes = 4 * smem_floats(Bsz, D, E);
    if (blocks > sms || bytes > max_smem) continue;
    int per_sm = 0;
    const int rc = dtype == 0 ? occupancy<float>(max_smem, (int)bytes, &per_sm)
                              : occupancy<__nv_bfloat16>(max_smem, (int)bytes, &per_sm);
    if (rc != 0) return rc;
    if (per_sm < 1) continue;
    out[0] = E;
    out[1] = (int)blocks;
    out[2] = (int)bytes;
    out[3] = sms;
    out[4] = n_parts(E);
    return 0;
  }
  return -1;
}

// Launches on `stream` with E from slstm_plan (called before on this
// device) and returns a cudaError_t as an int (0 on success): S = 1 the
// decode kernel, a plain launch; S > 1 the scan, a cooperative launch.  `u`
// [Bsz, S, 4 H D] of `dtype` (0: float32, 1: bfloat16) with element strides
// (u_sb, u_ss) and a contiguous last dimension; R [4, H, D, D], the initial
// and final states [Bsz, H, D], h_seq and the optional per-step c_seq /
// n_seq / m_seq (all three or none) [Bsz, S, H D] float32 and contiguous;
// `hx` [2, Bsz, H, D] 64-bit words, zero (null at S = 1).
extern "C" int slstm_launch(const void* u, int dtype, long long u_sb, long long u_ss,
                            const float* R, const float* c0, const float* n0, const float* h0,
                            const float* m0, float* h_seq, float* c_seq, float* n_seq,
                            float* m_seq, float* c_out, float* n_out, float* h_out, float* m_out,
                            unsigned long long* hx, int Bsz, int S, int H, int D, int E,
                            void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || D < 2 || E < 2 || E > kMaxE || D % E != 0 ||
      part_len(D, E) > kMaxKP || (dtype != 0 && dtype != 1) || (S > 1 && hx == nullptr))
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
  p.hx = hx;
  p.B = Bsz;
  p.S = S;
  p.H = H;
  p.D = D;
  p.E = E;
  const long long bytes = 4 * smem_floats(Bsz, D, E);
  const int blocks = H * (D / E);
  if (bytes > 232448 || (long long)S >= (1LL << 32) - 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(p, blocks, (int)bytes, s)
                                     : launch<__nv_bfloat16>(p, blocks, (int)bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
