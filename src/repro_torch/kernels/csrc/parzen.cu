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
// is floored at 1e-30 before the log, exactly as the TPU kernel does.  A NaN
// in a candidate or a component gives NaN, as in the plain version (the
// floor lets NaN through).
//
// Design.  The TPU kernel carries each side's online (m, l) logsumexp state
// in VMEM scratch across a sequential grid axis over component blocks.  CUDA
// blocks run in no order, so here the component axis is split across blocks
// and warps, and the partial states are merged in the same launch:
//   - the grid is (candidate tiles of 32, component slices).  The number of
//     slices is chosen on the host so that every shape fills the card: the
//     main path's 24 candidates against thousands of components run on tens
//     of SMs, not one, and 4096 candidates on several blocks an SM;
//   - a block stages its slice of each side (at most kSlice components a
//     side) in shared memory; each lane owns one candidate, and the wpc
//     warps of a group split the slice's components (warp w of the group
//     folds components w, w + wpc, ...) into kChains independent (m, l)
//     pairs a side (several exps in flight).  With many components a tile
//     takes all 8 warps of a block; with few (one slice, under 32 of the
//     longer side a warp) a warp takes a tile alone and a block holds up to
//     8 tiles, so a small call pays for no merge;
//   - the group merges its chains and warps in a fixed order; with one
//     slice it writes the score, else its partial (m, l) pairs go to a
//     workspace, and the last block of each candidate tile (an atomic ticket
//     taken after __threadfence) merges every slice's partials in slice
//     order and resets the ticket to zero for the next launch.
// Every merge runs in an order fixed by the indices alone, never by block
// scheduling, so a score is bitwise the same from run to run: seeded TPE
// studies do not depend on the card's timing.  Each side runs over its own
// length, so the two mixtures need no common padding.
//
// Bound on this card.  Per (candidate, component) the work is one exp and
// about 8 FP32 operations; the inputs are a few KB.  So the special-function
// unit's exp rate (16 per clock per SM) over all 132 SMs and launch latency
// bound it, never the bytes.  The update below spends exactly one exp per
// component (it rescales whichever of the running sum and the new term is
// smaller), and the exponents are kept in base 2 (log2(e) folded into the
// staged components), so each term is one exp2f, the special-function unit's
// own operation, where expf adds a range reduction; the instructions around
// the exps, not the exps, set the time.  Built without --use_fast_math:
// exp2f / logf keep full float32 accuracy (2 ulp, as expf).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileC = 32;     // candidates a warp group, one a lane
constexpr int kSlice = 1024;   // most components a side a block stages
constexpr int kMinSlice = 64;  // fewest components of the longer side a slice is cut to
constexpr int kChains = 4;     // independent (m, l) accumulators a side a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig2 = -1e30f * kLog2e;  // the -1e30 clamp, in base 2
constexpr float kRootHalfLog2e = 0.8493218002880191f;  // sqrt(log2(e) / 2)

// Online logsumexp in base 2: exponents are log2(e) times the natural ones,
// so every term is one exp2f (full float32 accuracy, like expf, in fewer
// instructions).
struct OnlineLse {
  float m;
  float l;

  __device__ __forceinline__ void init() {
    m = kNegBig2;
    l = 0.f;
  }

  // Fold one exponent in with a single exp.
  __device__ __forceinline__ void push(float e) {
    const float d = e - m;
    const float x = exp2f(-fabsf(d));
    if (d > 0.f) {
      l = fmaf(l, x, 1.f);
      m = e;
    } else {
      l += x;
    }
  }

  __device__ __forceinline__ void merge(float om, float ol) {
    const float mn = fmaxf(m, om);
    l = l * exp2f(m - mn) + ol * exp2f(om - mn);
    m = mn;
  }

  // natural log of the sum, floored at 1e-30 (a NaN sum stays NaN)
  __device__ __forceinline__ float log_sum() const {
    return m * kLn2 + logf(l < 1e-30f ? 1e-30f : l);
  }
};

// Clamped base-2 exponent of one (candidate, component) pair, the component
// staged as (mu, sqrt(log2(e) / 2) / sigma, log2(e) log_norm); NaN propagates.
__device__ __forceinline__ float exponent(float c, float4 comp) {
  const float z = (c - comp.x) * comp.y;
  const float e = fmaf(-z, z, comp.z);
  return e < kNegBig2 ? kNegBig2 : e;
}

// Folds components first, first + stride, ... of a staged side into `acc`,
// kChains at a time, and merges the chains in order.
__device__ __forceinline__ void accumulate(OnlineLse (&acc)[kChains], float c,
                                           const float4* comp, int n, int first, int stride) {
  int k = first;
  for (; k + (kChains - 1) * stride < n; k += kChains * stride) {
#pragma unroll
    for (int u = 0; u < kChains; ++u) acc[u].push(exponent(c, comp[k + u * stride]));
  }
  for (; k < n; k += stride) acc[0].push(exponent(c, comp[k]));
#pragma unroll
  for (int u = 1; u < kChains; ++u) acc[0].merge(acc[u].m, acc[u].l);
}

__device__ __forceinline__ void stage(float4* dst, const float* mu, const float* sigma,
                                      const float* ln, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    dst[k] = make_float4(mu[k], kRootHalfLog2e / sigma[k], ln[k] * kLog2e, 0.f);
  }
}

// Merges the (m, l) pairs s_part[side][w0 .. w0 + n - 1][lane] in order.
__device__ __forceinline__ void merge_warps(OnlineLse (&side)[2],
                                            const float2 (*s_part)[kWarps][kTileC], int w0, int n,
                                            int lane) {
#pragma unroll
  for (int sd = 0; sd < 2; ++sd) {
    side[sd].m = s_part[sd][w0][lane].x;
    side[sd].l = s_part[sd][w0][lane].y;
    for (int w = 1; w < n; ++w) {
      side[sd].merge(s_part[sd][w0 + w][lane].x, s_part[sd][w0 + w][lane].y);
    }
  }
}

// Grid (blocks of blockDim.x / (32 wpc) candidate tiles, component slices),
// wpc = 2^wpc_log2.  The wpc warps of a group split the slice's components
// for one tile of 32 candidates; with one slice (wpc below 8 only then) the
// group writes the scores, else each block of kThreads holds one tile and
// the tile's last block merges the slices' partials.
__global__ void __launch_bounds__(kThreads)
parzen_score_kernel(const float* __restrict__ cands, int n_cands,
                    const float* __restrict__ l_mu, const float* __restrict__ l_sigma,
                    const float* __restrict__ l_ln, int n_l,
                    const float* __restrict__ g_mu, const float* __restrict__ g_sigma,
                    const float* __restrict__ g_ln, int n_g, int slice_l, int slice_g,
                    int wpc_log2,
                    float2* __restrict__ partial, unsigned int* __restrict__ tickets,
                    float* __restrict__ out) {
  __shared__ float4 s_comp[2][kSlice];
  __shared__ float2 s_part[2][kWarps][kTileC];
  __shared__ bool s_last;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wpc = 1 << wpc_log2;
  const int group = warp >> wpc_log2, wg = warp & (wpc - 1);
  const int tile = blockIdx.x * ((blockDim.x >> 5) >> wpc_log2) + group;
  const int slice = blockIdx.y;
  const int n_slices = gridDim.y;
  const int l0 = slice * slice_l, g0 = slice * slice_g;
  const int nl = max(0, min(slice_l, n_l - l0));
  const int ng = max(0, min(slice_g, n_g - g0));
  stage(s_comp[0], l_mu + l0, l_sigma + l0, l_ln + l0, nl);
  stage(s_comp[1], g_mu + g0, g_sigma + g0, g_ln + g0, ng);
  __syncthreads();

  const int i = tile * kTileC + lane;
  const float c = i < n_cands ? cands[i] : 0.f;
  OnlineLse acc[2][kChains];
#pragma unroll
  for (int u = 0; u < kChains; ++u) {
    acc[0][u].init();
    acc[1][u].init();
  }
  accumulate(acc[0], c, s_comp[0], nl, wg, wpc);
  accumulate(acc[1], c, s_comp[1], ng, wg, wpc);
  if (wpc == 1 && n_slices == 1) {  // the warp holds the whole sums
    if (i < n_cands) out[i] = acc[0][0].log_sum() - acc[1][0].log_sum();
    return;
  }
  s_part[0][warp][lane] = make_float2(acc[0][0].m, acc[0][0].l);
  s_part[1][warp][lane] = make_float2(acc[1][0].m, acc[1][0].l);
  __syncthreads();

  // the group's state: its warps merged in order
  OnlineLse side[2];
  if (wg == 0) {
    merge_warps(side, s_part, warp, wpc, lane);
    if (n_slices == 1) {
      if (i < n_cands) out[i] = side[0].log_sum() - side[1].log_sum();
      return;
    }
    if (i < n_cands) {
#pragma unroll
      for (int sd = 0; sd < 2; ++sd) {
        partial[(sd * n_slices + slice) * (long long)n_cands + i] =
            make_float2(side[sd].m, side[sd].l);
      }
    }
    __threadfence();  // the partials are visible to the block that merges them
  }
  if (n_slices == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(n_slices - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block of the tile (wpc = kWarps): warp w merges slices w, w + 8,
  // ... in order, then warp 0 merges the warps in order
  OnlineLse tot[2];
  tot[0].init();
  tot[1].init();
  if (i < n_cands) {
    for (int s = warp; s < n_slices; s += kWarps) {
#pragma unroll
      for (int sd = 0; sd < 2; ++sd) {
        const float2 v = __ldcg(&partial[(sd * n_slices + s) * (long long)n_cands + i]);
        tot[sd].merge(v.x, v.y);
      }
    }
  }
  __syncthreads();  // s_part's first merge is read
  s_part[0][warp][lane] = make_float2(tot[0].m, tot[0].l);
  s_part[1][warp][lane] = make_float2(tot[1].m, tot[1].l);
  __syncthreads();
  if (warp == 0) {
    merge_warps(side, s_part, 0, kWarps, lane);
    if (i < n_cands) out[i] = side[0].log_sum() - side[1].log_sum();
    if (lane == 0) tickets[tile] = 0u;
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Number of component slices the launch splits both sides into for n_cands
// candidates against n_l and n_g components on a card of `sms` SMs: at
// least enough that a slice fits kSlice components a side, and up to about
// four blocks an SM while a slice keeps kMinSlice components of the longer
// side.
int slices_for(int n_cands, int n_l, int n_g, int sms) {
  const int k = n_l > n_g ? n_l : n_g;
  const int tiles = cdiv(n_cands, kTileC);
  const int fit = cdiv(k, kSlice);
  const int fill = min(cdiv(4 * sms, tiles), cdiv(k, kMinSlice));
  return max(1, max(fit, fill));
}

// The launch's two workspaces with n_slices > 1: one ticket a candidate
// tile (unsigned ints) and 2 x n_slices x n_cands float2 partials.  Each has
// a buffer of its own, so a ticket buffer holds tickets alone and stays zero
// between launches of any shape.
long long ticket_bytes(int n_cands, int n_slices) {
  return n_slices == 1 ? 0 : (long long)sizeof(unsigned int) * cdiv(n_cands, kTileC);
}

long long partial_bytes(int n_cands, int n_slices) {
  return n_slices == 1 ? 0 : 2LL * n_slices * n_cands * (long long)sizeof(float2);
}

}  // namespace

// Bytes of the two workspaces parzen_score_launch needs for these sizes on
// a card of `sms` SMs: sizes[0] the tickets, sizes[1] the partials (both 0
// when the components fit one slice).
extern "C" void parzen_score_workspace(int n_cands, int n_l, int n_g, int sms,
                                       long long* sizes) {
  const int n_slices = slices_for(n_cands, n_l, n_g, sms);
  sizes[0] = ticket_bytes(n_cands, n_slices);
  sizes[1] = partial_bytes(n_cands, n_slices);
}

// Launches the kernel on `stream` and returns cudaGetLastError() as an int
// (0 on success), or -1 without launching when a workspace is smaller than
// parzen_score_workspace(...) gives for these sizes.  All float pointers are
// device pointers to float32; the caller allocates `out` ([n_cands]), the
// tickets, zero on entry (a zeroed buffer) and left zero by every launch,
// and the partials, and guarantees n_cands, n_l, n_g >= 1.  With one slice,
// a tile's warps share its components only while each keeps 32 or more of
// the longer side (fewer, and the merge costs more than the split saves):
// wpc warps a tile in blocks of 8 warps, or, for a warp alone on its tile,
// blocks of 4 warps (a small call starts sooner on them).
extern "C" int parzen_score_launch(const float* cands, int n_cands,
                                   const float* l_mu, const float* l_sigma,
                                   const float* l_ln, int n_l,
                                   const float* g_mu, const float* g_sigma,
                                   const float* g_ln, int n_g, int sms,
                                   unsigned int* tickets, long long tickets_size,
                                   void* partial, long long partial_size,
                                   float* out, void* stream) {
  if (n_cands < 1 || n_l < 1 || n_g < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slices = slices_for(n_cands, n_l, n_g, sms);
  if (tickets_size < ticket_bytes(n_cands, n_slices) ||
      partial_size < partial_bytes(n_cands, n_slices))
    return -1;
  const int slice_l = cdiv(n_l, n_slices), slice_g = cdiv(n_g, n_slices);
  int wpc_log2 = 3;  // kWarps
  if (n_slices == 1) {
    const int per = (slice_l > slice_g ? slice_l : slice_g) / 32;
    wpc_log2 = 0;
    while (wpc_log2 < 3 && (2 << wpc_log2) <= per) ++wpc_log2;
  }
  const int threads = wpc_log2 == 0 ? kThreads / 2 : kThreads;
  const dim3 grid(cdiv(cdiv(n_cands, kTileC), (threads / 32) >> wpc_log2), n_slices);
  parzen_score_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cands, n_cands, l_mu, l_sigma, l_ln, n_l, g_mu, g_sigma, g_ln, n_g, slice_l, slice_g,
      wpc_log2, static_cast<float2*>(partial), tickets, out);
  return static_cast<int>(cudaGetLastError());
}
