// Fused Parzen-score kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/parzen.py::parzen_score_kernel, the Pallas TPU
// kernel that _parzen_padded launches through pl.pallas_call.
//
// Computes, for every candidate x, the TPE acquisition log l(x) - log g(x)
// against two truncated-Gaussian mixtures given as (mu, sigma, log_norm)
// component triples: log_side(x) = logsumexp_k(-0.5 ((x - mu_k) / sigma_k)^2
// + log_norm_k).  Padding components carry log_norm = -inf; every exponent is
// clamped at -1e30 so that (-inf) - (-inf) never appears, and the running sum
// is floored at 1e-30 before the log, exactly as the TPU kernel does.
//
// Design.  The TPU kernel carries each side's online (m, l) logsumexp state
// in VMEM scratch across a sequential grid axis over component blocks.  CUDA
// blocks run in no order, so here one block owns a tile of kThreads
// candidates (one per thread) and loops over the component axis itself: each
// tile of up to kTile components per side is staged in shared memory
// (mu, 1/sigma, log_norm: 6 x 1024 x 4 B = 24 KB for both sides) and every
// thread folds it into (m, l) pairs held in registers.  Each side runs over
// its own length, so the two mixtures need no common padding.
//
// Bound on this card.  Per (candidate, component) the work is one exp and
// about 8 FP32 operations; the inputs are a few KB.  So the special-function
// unit's exp rate (16 per clock per SM) and launch latency bound it, never the
// bytes.  The update below spends exactly one exp per component (it rescales
// whichever of the running sum and the new term is smaller), and kChains
// independent (m, l) pairs per side keep several exps in flight per thread
// instead of one serial dependency chain.  Built without --use_fast_math:
// expf/logf keep full float32 accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // candidates per block, one per thread
constexpr int kTile = 1024;    // components per side staged per tile
constexpr int kChains = 4;     // independent (m, l) accumulators per side
constexpr float kNegBig = -1e30f;

struct OnlineLse {
  float m;
  float l;

  __device__ __forceinline__ void init() {
    m = kNegBig;
    l = 0.f;
  }

  // Fold one exponent in with a single exp.
  __device__ __forceinline__ void push(float e) {
    const float d = e - m;
    const float x = expf(-fabsf(d));
    if (d > 0.f) {
      l = fmaf(l, x, 1.f);
      m = e;
    } else {
      l += x;
    }
  }

  __device__ __forceinline__ void merge(const OnlineLse& o) {
    const float mn = fmaxf(m, o.m);
    l = l * expf(m - mn) + o.l * expf(o.m - mn);
    m = mn;
  }

  __device__ __forceinline__ float log_sum() const {
    return m + logf(fmaxf(l, 1e-30f));
  }
};

// Clamped exponent of one (candidate, component) pair; NaN propagates.
__device__ __forceinline__ float exponent(float c, float mu, float inv_sigma, float ln) {
  const float z = (c - mu) * inv_sigma;
  const float e = fmaf(-0.5f * z, z, ln);
  return e < kNegBig ? kNegBig : e;
}

__device__ __forceinline__ void accumulate(OnlineLse (&acc)[kChains], float c,
                                           const float* mu, const float* inv_sigma,
                                           const float* ln, int n) {
  int k = 0;
  for (; k + kChains <= n; k += kChains) {
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      acc[u].push(exponent(c, mu[k + u], inv_sigma[k + u], ln[k + u]));
    }
  }
  for (; k < n; ++k) {
    acc[0].push(exponent(c, mu[k], inv_sigma[k], ln[k]));
  }
}

__device__ __forceinline__ void stage(float* s_mu, float* s_inv, float* s_ln,
                                      const float* mu, const float* sigma,
                                      const float* ln, int n) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    s_mu[k] = mu[k];
    s_inv[k] = 1.f / sigma[k];
    s_ln[k] = ln[k];
  }
}

__global__ void __launch_bounds__(kThreads)
parzen_score_kernel(const float* __restrict__ cands, int n_cands,
                    const float* __restrict__ l_mu, const float* __restrict__ l_sigma,
                    const float* __restrict__ l_ln, int n_l,
                    const float* __restrict__ g_mu, const float* __restrict__ g_sigma,
                    const float* __restrict__ g_ln, int n_g,
                    float* __restrict__ out) {
  __shared__ float s_mu[2][kTile];
  __shared__ float s_inv[2][kTile];
  __shared__ float s_ln[2][kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  // threads past the ragged candidate edge still help stage tiles
  const float c = i < n_cands ? cands[i] : 0.f;

  OnlineLse acc_l[kChains];
  OnlineLse acc_g[kChains];
#pragma unroll
  for (int u = 0; u < kChains; ++u) {
    acc_l[u].init();
    acc_g[u].init();
  }

  const int n_max = n_l > n_g ? n_l : n_g;
  for (int base = 0; base < n_max; base += kTile) {
    const int tl = max(0, min(kTile, n_l - base));
    const int tg = max(0, min(kTile, n_g - base));
    stage(s_mu[0], s_inv[0], s_ln[0], l_mu + base, l_sigma + base, l_ln + base, tl);
    stage(s_mu[1], s_inv[1], s_ln[1], g_mu + base, g_sigma + base, g_ln + base, tg);
    __syncthreads();
    accumulate(acc_l, c, s_mu[0], s_inv[0], s_ln[0], tl);
    accumulate(acc_g, c, s_mu[1], s_inv[1], s_ln[1], tg);
    __syncthreads();
  }

  if (i < n_cands) {
#pragma unroll
    for (int u = 1; u < kChains; ++u) {
      acc_l[0].merge(acc_l[u]);
      acc_g[0].merge(acc_g[u]);
    }
    out[i] = acc_l[0].log_sum() - acc_g[0].log_sum();
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success).  All pointers are device pointers to float32; the caller
// allocates `out` ([n_cands]) and guarantees n_cands, n_l, n_g >= 1.
extern "C" int parzen_score_launch(const float* cands, int n_cands,
                                   const float* l_mu, const float* l_sigma,
                                   const float* l_ln, int n_l,
                                   const float* g_mu, const float* g_sigma,
                                   const float* g_ln, int n_g,
                                   float* out, void* stream) {
  const int blocks = (n_cands + kThreads - 1) / kThreads;
  parzen_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cands, n_cands, l_mu, l_sigma, l_ln, n_l, g_mu, g_sigma, g_ln, n_g, out);
  return static_cast<int>(cudaGetLastError());
}
