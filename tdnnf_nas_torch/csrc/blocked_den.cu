// Blocked LF-MMI denominator scan: forward and exact adjoint, for Hopper.
//
// Replaces the Pallas pair `_blk_fwd_kernel` / `_blk_bwd_kernel`
// (tdnnf_nas_tpu/ops/pallas_fwdbwd.py) and computes what the XLA twin
// `_blocked_score_core` (tdnnf_nas_tpu/ops/fwdbwd.py) computes.  Layout per
// superblock c (C superblocks, NDP = R*NDPOS + NSRC slots, V = C*NDP):
//
//     [ R*NDPOS enter slots, r-major (slot r*NDPOS + i) | NSRC loop slots ]
//
// Forward, per frame t >= 1 (three launches):
//   1. assemble beta [B, C*NSRC]: beta[j] = sum_r alpha[enter(perm[j], r)]
//      + alpha[loop j] + leaky*init_pos[j]  (perm[j] == C*NDPOS: no enter);
//   2. tiled block product a[b, c*NDP+d] = sum_s beta[b, c*NSRC+s]*W[c,s,d],
//      times obs[b,t,.] (f32 or bf16, upcast in registers), written
//      unnormalized into alphas[t], plus one partial row sum per block;
//   3. per row: reduce the partials in a fixed order, clamp at 1e-30,
//      divide, record the scale and add its log to logZ.
// Backward, per frame t <= T-2 (two launches): the transposed block product
// u = W^T v (reading W along d, no W^T copy, split over d into partials),
// then per row the inverse permutation (perm_inv, sentinel C*NSRC = zero),
// the broadcast to the R enter slots and the loop slice,
// bar = g - sum(g*alpha) + gbar, grad_obs = alpha*bar / max(obs, 1e-30)
// written in obs's dtype, and the carrier (bar / c_t) * obs_t.
//
// Every reduction runs in a fixed order with no atomics, so runs repeat
// bit for bit.  What bounds it on an H100: per frame the block product is
// 2*B*C*NSRC*NDP flops (about 1.3 GFLOP at the flagship B=64, C=7,
// NSRC=538, NDP=2690) against a 40.5 MB W that fits the 50 MB L2, so the
// float32 FMA rate of a simple shared-memory tiling bounds it, with about
// five launches per frame on top.  wgmma, TMA and a persistent kernel
// that keeps the scan on chip are later work.
// The wildcard (rank-R broadcast) term of committed +-1 graphs is not
// implemented here; the Python wrapper refuses such graphs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kTiny = 1e-30f;
constexpr float kObsFloor = 1e-30f;
constexpr int BM = 64;  // rows (batch) per tile
constexpr int BN = 64;  // columns per tile
constexpr int BK = 16;  // depth per shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int kTileThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kRowThreads = 512;
constexpr int kBwdChunk = 512;  // d-range of one backward split (mult. of BK)

__device__ __forceinline__ float load_obs(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_obs(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_grad(float* p, size_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_grad(__nv_bfloat16* p, size_t i,
                                           float x) {
  p[i] = __float2bfloat16(x);
}

// Deterministic block sum (fixed tree over shared memory); every thread of
// the block gets the total.  blockDim.x must equal N (a power of two).
template <int N>
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  float out = red[0];
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------- forward

// Frame 0: alpha0 = init_v * obs[:, 0], normalized.  One block per row.
template <typename ObsT>
__global__ void fwd_frame0(const ObsT* __restrict__ obs,
                           const float* __restrict__ init_v, int T, int V,
                           float* __restrict__ alpha0, float* __restrict__ cs0,
                           float* __restrict__ logz) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const size_t obase = (size_t)b * T * V;
  float* row = alpha0 + (size_t)b * V;
  float s = 0.f;
  for (int v = threadIdx.x; v < V; v += kRowThreads) {
    const float a = init_v[v] * load_obs(obs, obase + v);
    row[v] = a;
    s += a;
  }
  const float c = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  for (int v = threadIdx.x; v < V; v += kRowThreads) row[v] = row[v] / c;
  if (threadIdx.x == 0) {
    cs0[b] = c;
    logz[b] = logf(c);
  }
}

// beta [B, C*NSRC] from the previous frame's normalized alpha [B, V].
__global__ void fwd_assemble_beta(const float* __restrict__ alpha,
                                  const int* __restrict__ perm,
                                  const float* __restrict__ init_pos,
                                  float leaky, int B, int C, int NSRC,
                                  int NDP, int NDPOS, int R,
                                  float* __restrict__ beta) {
  const int cs_total = C * NSRC;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * cs_total) return;
  const int b = (int)(idx / cs_total);
  const int j = (int)(idx % cs_total);
  const float* arow = alpha + (size_t)b * C * NDP;
  const int c = j / NSRC;
  const int s = j % NSRC;
  float x = arow[(size_t)c * NDP + R * NDPOS + s];  // loop slot
  const int k = perm[j];
  if (k < C * NDPOS) {
    const float* e = arow + (size_t)(k / NDPOS) * NDP + (k % NDPOS);
    float acc = e[0];
    for (int r = 1; r < R; ++r) acc += e[(size_t)r * NDPOS];
    x = acc + x;
  }
  if (leaky > 0.f) x += leaky * init_pos[j];
  beta[idx] = x;
}

// a[b, c*NDP + d] = (sum_s beta[b, c*NSRC + s] * W[c, s, d]) * obs[b, t, .]
// Grid (ceil(NDP/BN), C, ceil(B/BM)); one partial row sum per block.
template <typename ObsT>
__global__ void __launch_bounds__(kTileThreads)
fwd_block_product(const float* __restrict__ beta, const float* __restrict__ w,
                  const ObsT* __restrict__ obs, int t, int T, int B, int C,
                  int NSRC, int NDP, float* __restrict__ a_out,
                  float* __restrict__ partial, int P) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  __shared__ float red[BM][BN / TN + 1];
  const int tile_n = blockIdx.x;
  const int c = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int n0 = tile_n * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int cs_total = C * NSRC;
  const float* wc = w + (size_t)c * NSRC * NDP;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < NSRC; k0 += BK) {
    for (int e = tid; e < BK * BM; e += kTileThreads) {
      const int m = e / BK, k = e % BK;
      const int b = m0 + m, s = k0 + k;
      As[k][m] = (b < B && s < NSRC)
                     ? beta[(size_t)b * cs_total + (size_t)c * NSRC + s]
                     : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kTileThreads) {
      const int k = e / BN, n = e % BN;
      const int s = k0 + k, d = n0 + n;
      Bs[k][n] = (s < NSRC && d < NDP) ? wc[(size_t)s * NDP + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t V = (size_t)C * NDP;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = m0 + ty * TM + i;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = n0 + tx * TN + j;
      if (b < B && d < NDP) {
        const size_t col = (size_t)c * NDP + d;
        const float val =
            acc[i][j] * load_obs(obs, ((size_t)b * T + t) * V + col);
        a_out[(size_t)b * V + col] = val;
        rs += val;
      }
    }
    red[ty * TM + i][tx] = rs;
  }
  __syncthreads();
  if (tid < BM) {
    const int b = m0 + tid;
    if (b < B) {
      float s = 0.f;
      for (int q = 0; q < BN / TN; ++q) s += red[tid][q];
      partial[(size_t)b * P + (size_t)c * gridDim.x + tile_n] = s;
    }
  }
}

// Reduce the partial row sums, clamp, normalize alpha_t in place.
__global__ void fwd_normalize(float* __restrict__ a,
                              const float* __restrict__ partial, int P, int V,
                              float* __restrict__ cs_t,
                              float* __restrict__ logz) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  float s = 0.f;
  for (int p = threadIdx.x; p < P; p += kRowThreads)
    s += partial[(size_t)b * P + p];
  const float c = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  float* row = a + (size_t)b * V;
  for (int v = threadIdx.x; v < V; v += kRowThreads) row[v] = row[v] / c;
  if (threadIdx.x == 0) {
    cs_t[b] = c;
    logz[b] += logf(c);
  }
}

// logZ += log max(sum alpha_last * final_v, 1e-30).
__global__ void fwd_final(const float* __restrict__ alpha_last,
                          const float* __restrict__ final_v, int V,
                          float* __restrict__ logz) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const float* row = alpha_last + (size_t)b * V;
  float s = 0.f;
  for (int v = threadIdx.x; v < V; v += kRowThreads) s += row[v] * final_v[v];
  const float z = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  if (threadIdx.x == 0) logz[b] += logf(z);
}

// --------------------------------------------------------------- backward

// Last frame: g = gbar*final_v/zfin, bar = g - sum(g*alpha) + gbar.
template <typename ObsT>
__global__ void bwd_last(const float* __restrict__ alpha_last,
                         const ObsT* __restrict__ obs,
                         const float* __restrict__ final_v,
                         const float* __restrict__ cs_last,
                         const float* __restrict__ gbar, int T, int V,
                         ObsT* __restrict__ grad, float* __restrict__ vcar) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const int t = T - 1;
  const float* row = alpha_last + (size_t)b * V;
  const float gb = gbar[b];
  float s = 0.f;
  for (int v = threadIdx.x; v < V; v += kRowThreads) s += row[v] * final_v[v];
  const float zfin = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  float dot = 0.f;
  for (int v = threadIdx.x; v < V; v += kRowThreads)
    dot += (gb * final_v[v] / zfin) * row[v];
  dot = block_sum<kRowThreads>(dot, red);
  const float ct = cs_last[b];
  for (int v = threadIdx.x; v < V; v += kRowThreads) {
    const float bar = gb * final_v[v] / zfin - dot + gb;
    const size_t oi = ((size_t)b * T + t) * V + v;
    const float o = load_obs(obs, oi);
    store_grad(grad, oi, row[v] * bar / fmaxf(o, kObsFloor));
    vcar[(size_t)b * V + v] = (bar / ct) * o;
  }
}

// upart[split, b, c*NSRC + s] = sum_{d in split} vcar[b, c*NDP + d] * W[c,s,d]
// Grid (ceil(NSRC/BN), C*ceil(B/BM), splits).
__global__ void __launch_bounds__(kTileThreads)
bwd_block_product_t(const float* __restrict__ vcar,
                    const float* __restrict__ w, int B, int C, int NSRC,
                    int NDP, float* __restrict__ upart) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tile_n = blockIdx.x;
  const int c = blockIdx.y % C;
  const int m0 = (blockIdx.y / C) * BM;
  const int split = blockIdx.z;
  const int n0 = tile_n * BN;
  const int d_begin = split * kBwdChunk;
  const int d_end = min(NDP, d_begin + kBwdChunk);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const size_t V = (size_t)C * NDP;
  const float* wc = w + (size_t)c * NSRC * NDP;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = d_begin; k0 < d_end; k0 += BK) {
    for (int e = tid; e < BK * BM; e += kTileThreads) {
      const int m = e / BK, k = e % BK;
      const int b = m0 + m, d = k0 + k;
      As[k][m] = (b < B && d < d_end)
                     ? vcar[(size_t)b * V + (size_t)c * NDP + d]
                     : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kTileThreads) {
      const int n = e / BK, k = e % BK;
      const int s = n0 + n, d = k0 + k;
      Bs[k][n] = (s < NSRC && d < d_end) ? wc[(size_t)s * NDP + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int cs_total = C * NSRC;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int s = n0 + tx * TN + j;
      if (b < B && s < NSRC)
        upart[((size_t)split * B + b) * cs_total + (size_t)c * NSRC + s] =
            acc[i][j];
    }
  }
}

// Frame t <= T-2: gg = L^T(vcar) assembled from the split partials, then
// bar, the obs gradient and the next carrier.  One block per row.
template <typename ObsT>
__global__ void bwd_frame(const float* __restrict__ upart, int splits,
                          const int* __restrict__ perm_inv,
                          const float* __restrict__ alpha_t,
                          const ObsT* __restrict__ obs,
                          const float* __restrict__ cs_t,
                          const float* __restrict__ gbar, int t, int T, int B,
                          int C, int NSRC, int NDP, int NDPOS, int R,
                          float* __restrict__ gg, ObsT* __restrict__ grad,
                          float* __restrict__ vcar) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const int cs_total = C * NSRC;
  const int V = C * NDP;
  const float* arow = alpha_t + (size_t)b * V;
  float* grow = gg + (size_t)b * V;
  float dot = 0.f;
  for (int v = threadIdx.x; v < V; v += kRowThreads) {
    const int c = v / NDP;
    const int d = v % NDP;
    int j;
    if (d < R * NDPOS)
      j = perm_inv[c * NDPOS + (d % NDPOS)];
    else
      j = c * NSRC + (d - R * NDPOS);
    float x = 0.f;
    if (j < cs_total) {
      for (int sp = 0; sp < splits; ++sp)
        x += upart[((size_t)sp * B + b) * cs_total + j];
    }
    grow[v] = x;
    dot += x * arow[v];
  }
  dot = block_sum<kRowThreads>(dot, red);
  const float gb = gbar[b];
  const float ct = cs_t[b];
  for (int v = threadIdx.x; v < V; v += kRowThreads) {
    const float bar = grow[v] - dot + gb;
    const size_t oi = ((size_t)b * T + t) * V + v;
    const float o = load_obs(obs, oi);
    store_grad(grad, oi, arow[v] * bar / fmaxf(o, kObsFloor));
    vcar[(size_t)b * V + v] = (bar / ct) * o;
  }
}

template <typename ObsT>
cudaError_t fwd_impl(const ObsT* obs, const float* w, const int* perm,
                     const float* init_pos, const float* init_v,
                     const float* final_v, float leaky, int B, int T, int C,
                     int NSRC, int NDP, int R, float* alphas, float* cs,
                     float* logz, float* beta, float* partial,
                     cudaStream_t st) {
  const int NDPOS = (NDP - NSRC) / R;
  const int V = C * NDP;
  const int tiles_n = (NDP + BN - 1) / BN;
  const int tiles_m = (B + BM - 1) / BM;
  const int P = C * tiles_n;
  const size_t plane = (size_t)B * V;
  const int cs_total = C * NSRC;
  const int beta_blocks = (int)(((size_t)B * cs_total + 255) / 256);
  cudaError_t err;
  fwd_frame0<ObsT><<<B, kRowThreads, 0, st>>>(obs, init_v, T, V, alphas, cs,
                                              logz);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int t = 1; t < T; ++t) {
    const float* prev = alphas + (size_t)(t - 1) * plane;
    float* cur = alphas + (size_t)t * plane;
    fwd_assemble_beta<<<beta_blocks, 256, 0, st>>>(
        prev, perm, init_pos, leaky, B, C, NSRC, NDP, NDPOS, R, beta);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    fwd_block_product<ObsT><<<dim3(tiles_n, C, tiles_m), kTileThreads, 0,
                               st>>>(beta, w, obs, t, T, B, C, NSRC, NDP, cur,
                                     partial, P);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    fwd_normalize<<<B, kRowThreads, 0, st>>>(cur, partial, P, V,
                                             cs + (size_t)t * B, logz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  fwd_final<<<B, kRowThreads, 0, st>>>(alphas + (size_t)(T - 1) * plane,
                                       final_v, V, logz);
  return cudaGetLastError();
}

template <typename ObsT>
cudaError_t bwd_impl(const ObsT* obs, const float* w, const int* perm_inv,
                     const float* final_v, const float* alphas,
                     const float* cs, const float* gbar, int B, int T, int C,
                     int NSRC, int NDP, int R, ObsT* grad, float* vcar,
                     float* gg, float* upart, cudaStream_t st) {
  const int NDPOS = (NDP - NSRC) / R;
  const int V = C * NDP;
  const size_t plane = (size_t)B * V;
  const int splits = (NDP + kBwdChunk - 1) / kBwdChunk;
  const int tiles_s = (NSRC + BN - 1) / BN;
  const int tiles_m = (B + BM - 1) / BM;
  cudaError_t err;
  bwd_last<ObsT><<<B, kRowThreads, 0, st>>>(
      alphas + (size_t)(T - 1) * plane, obs, final_v, cs + (size_t)(T - 1) * B,
      gbar, T, V, grad, vcar);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int t = T - 2; t >= 0; --t) {
    bwd_block_product_t<<<dim3(tiles_s, C * tiles_m, splits), kTileThreads, 0,
                          st>>>(vcar, w, B, C, NSRC, NDP, upart);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_frame<ObsT><<<B, kRowThreads, 0, st>>>(
        upart, splits, perm_inv, alphas + (size_t)t * plane, obs,
        cs + (size_t)t * B, gbar, t, T, B, C, NSRC, NDP, NDPOS, R, gg, grad,
        vcar);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Number of partial row sums per row the forward needs (scratch sizing).
int blocked_den_fwd_partials(int C, int NDP) {
  return C * ((NDP + BN - 1) / BN);
}

// Number of d-splits of the backward's transposed product (scratch sizing).
int blocked_den_bwd_splits(int NDP) {
  return (NDP + kBwdChunk - 1) / kBwdChunk;
}

// Forward scan.  obs [B,T,V] (f32, or bf16 when obs_bf16); writes the
// normalized alphas [T,B,V], the scales cs [T,B] and logz [B].  Scratch:
// beta [B, C*NSRC], partial [B, blocked_den_fwd_partials(C, NDP)].
int blocked_den_fwd(const void* obs, int obs_bf16, const float* w,
                    const int* perm, const float* init_pos,
                    const float* init_v, const float* final_v, float leaky,
                    int B, int T, int C, int NSRC, int NDP, int R,
                    float* alphas, float* cs, float* logz, float* beta,
                    float* partial, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (obs_bf16)
    return (int)fwd_impl(static_cast<const __nv_bfloat16*>(obs), w, perm,
                         init_pos, init_v, final_v, leaky, B, T, C, NSRC, NDP,
                         R, alphas, cs, logz, beta, partial, st);
  return (int)fwd_impl(static_cast<const float*>(obs), w, perm, init_pos,
                       init_v, final_v, leaky, B, T, C, NSRC, NDP, R, alphas,
                       cs, logz, beta, partial, st);
}

// Adjoint scan.  Writes grad [B,T,V] = d(sum_b gbar_b logz_b)/d obs in
// obs's dtype.  Scratch: vcar [B,V], gg [B,V],
// upart [blocked_den_bwd_splits(NDP), B, C*NSRC].
int blocked_den_bwd(const void* obs, int obs_bf16, const float* w,
                    const int* perm_inv, const float* final_v,
                    const float* alphas, const float* cs, const float* gbar,
                    int B, int T, int C, int NSRC, int NDP, int R, void* grad,
                    float* vcar, float* gg, float* upart, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (obs_bf16)
    return (int)bwd_impl(static_cast<const __nv_bfloat16*>(obs), w, perm_inv,
                         final_v, alphas, cs, gbar, B, T, C, NSRC, NDP, R,
                         static_cast<__nv_bfloat16*>(grad), vcar, gg, upart,
                         st);
  return (int)bwd_impl(static_cast<const float*>(obs), w, perm_inv, final_v,
                       alphas, cs, gbar, B, T, C, NSRC, NDP, R,
                       static_cast<float*>(grad), vcar, gg, upart, st);
}

}  // extern "C"
