// Dense LF-MMI denominator scan: forward and exact adjoint, for Hopper.
//
// Replaces the Pallas pair `_fwd_kernel` / `_bwd_kernel`
// (tdnnf_nas_tpu/ops/pallas_fwdbwd.py) and computes what they compute, from
// state-indexed, max-normalized log observations obs [B, T, S] (float32),
// a shared transition matrix trans [S, S] and init/final [S]:
//
//   t = 0:  alpha_0 = init * exp(obs_0), normalized by c_0 = max(sum, 1e-30)
//   t >= 1: a = ((alpha_{t-1} (+ leaky*init if leaky > 0)) @ trans)
//               * exp(obs_t),  alpha_t = a / c_t,  c_t = max(sum a, 1e-30)
//   logZ = sum_t log c_t + log max(alpha_{T-1} . final, 1e-30)
//
// and the adjoint, over frames indexed backward (no flipped copies):
//
//   t = T-1: g = gbar * final / zfin
//   t < T-1: g = v_{t+1} @ trans^T             (streams rows of trans_T)
//   bar = g - (g . alpha_t) + gbar,  grad_t = alpha_t * bar   (log-space)
//   v_t = (bar / c_t) * exp(obs_t)
//
// Precision: float32 throughout.  The Pallas kernel casts trans and alpha
// to bf16 when S*S*4 exceeds 12 MiB (`_mm_dtype`), because a float32
// trans of the flagship's S = 2,208 (19.5 MB) does not fit the TPU's VMEM;
// that is a TPU workaround, and this port keeps float32 as the reference's
// XLA `forward_score` does.  At small S the Pallas kernel is float32 too.
//
// Layout, per frame (two launches): a split-K product
// part[split, b, n] = sum_{k in split} A[b, k] * M[k, n] in 64x64 output
// tiles (float32 FMA from shared memory), with K split so that about two
// blocks run on each of the H100's 132 SMs (B x S = 64 x 2,208 is only 35
// tiles); then one block per row sums the splits in a fixed order, applies
// exp(obs), and renormalizes (forward) or forms bar, grad and the next
// carrier (backward).  No atomics: two runs repeat bit for bit.
//
// What bounds it: 2*B*S*S = 0.62 GFLOP of float32 product per flagship
// frame against a 19.5 MB trans that stays in the 50 MB L2, so the FMA rate
// of the simple tiling, plus two launches per frame.  Tensor cores (whose
// TF32 would change the numbers), TMA and a persistent whole-scan kernel
// are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kTiny = 1e-30f;
constexpr int BM = 64;  // rows (batch) per tile
constexpr int BN = 64;  // columns (states) per tile
constexpr int BK = 16;  // depth per shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int kTileThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kRowThreads = 512;
constexpr int kTargetBlocks = 264;  // two product blocks per SM of an H100

// Depth of one K split, a multiple of BK: enough splits that the product
// launches about kTargetBlocks blocks, never more splits than BK-steps.
int k_chunk(int B, int S) {
  const int tiles = ((S + BN - 1) / BN) * ((B + BM - 1) / BM);
  const int ksteps = (S + BK - 1) / BK;
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  if (splits > ksteps) splits = ksteps;
  if (splits < 1) splits = 1;
  return ((ksteps + splits - 1) / splits) * BK;
}

int num_splits(int B, int S) {
  const int kc = k_chunk(B, S);
  return (S + kc - 1) / kc;
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

// part[split, b, n] = sum_{k in split} (src[b, k] + leaky*init[k]) * m[k, n]
// (the leaky term only when leaky > 0).  Grid (ceil(S/BN), ceil(B/BM),
// splits).
__global__ void __launch_bounds__(kTileThreads)
split_product(const float* __restrict__ src, const float* __restrict__ init,
              float leaky, const float* __restrict__ m, int B, int S,
              int kchunk, float* __restrict__ part) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * kchunk;
  const int k_end = min(S, k_begin + kchunk);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BK * BM; e += kTileThreads) {
      const int r = e / BK, k = e % BK;
      const int b = m0 + r, kk = k0 + k;
      float x = 0.f;
      if (b < B && kk < k_end) {
        x = src[(size_t)b * S + kk];
        if (leaky > 0.f) x += leaky * init[kk];
      }
      As[k][r] = x;
    }
    for (int e = tid; e < BK * BN; e += kTileThreads) {
      const int k = e / BN, n = e % BN;
      const int kk = k0 + k, col = n0 + n;
      Bs[k][n] = (kk < k_end && col < S) ? m[(size_t)kk * S + col] : 0.f;
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (b < B && col < S)
        part[((size_t)split * B + b) * S + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- forward

// Frame 0: alpha0 = init * exp(obs[:, 0]), normalized.  One block per row.
__global__ void fwd_frame0(const float* __restrict__ obs,
                           const float* __restrict__ init, int T, int S,
                           float* __restrict__ alpha0, float* __restrict__ cs0,
                           float* __restrict__ logz) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const float* o = obs + (size_t)b * T * S;
  float* row = alpha0 + (size_t)b * S;
  float s = 0.f;
  for (int j = threadIdx.x; j < S; j += kRowThreads) {
    const float a = init[j] * expf(o[j]);
    row[j] = a;
    s += a;
  }
  const float c = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  for (int j = threadIdx.x; j < S; j += kRowThreads) row[j] = row[j] / c;
  if (threadIdx.x == 0) {
    cs0[b] = c;
    logz[b] = logf(c);
  }
}

// Frame t >= 1: a = (sum of the split partials) * exp(obs[b, t]), then
// normalized into alpha_t; records c_t and adds log c_t to logZ.
__global__ void fwd_normalize(const float* __restrict__ part, int splits,
                              const float* __restrict__ obs, int t, int T,
                              int B, int S, float* __restrict__ alpha_t,
                              float* __restrict__ cs_t,
                              float* __restrict__ logz) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const float* o = obs + ((size_t)b * T + t) * S;
  float* row = alpha_t + (size_t)b * S;
  float s = 0.f;
  for (int j = threadIdx.x; j < S; j += kRowThreads) {
    float x = 0.f;
    for (int sp = 0; sp < splits; ++sp) x += part[((size_t)sp * B + b) * S + j];
    const float a = x * expf(o[j]);
    row[j] = a;
    s += a;
  }
  const float c = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  for (int j = threadIdx.x; j < S; j += kRowThreads) row[j] = row[j] / c;
  if (threadIdx.x == 0) {
    cs_t[b] = c;
    logz[b] += logf(c);
  }
}

// logZ += log max(sum alpha_last * final, 1e-30).
__global__ void fwd_final(const float* __restrict__ alpha_last,
                          const float* __restrict__ final_, int S,
                          float* __restrict__ logz) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const float* row = alpha_last + (size_t)b * S;
  float s = 0.f;
  for (int j = threadIdx.x; j < S; j += kRowThreads) s += row[j] * final_[j];
  const float z = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  if (threadIdx.x == 0) logz[b] += logf(z);
}

// --------------------------------------------------------------- backward

// Last frame: g = gbar * (final / zfin), bar = g - (g . alpha) + gbar,
// grad = alpha * bar, carrier v = (bar / c) * exp(obs).  One block per row.
__global__ void bwd_last(const float* __restrict__ alpha_last,
                         const float* __restrict__ obs,
                         const float* __restrict__ final_,
                         const float* __restrict__ cs_last,
                         const float* __restrict__ gbar, int T, int S,
                         float* __restrict__ grad, float* __restrict__ vcar) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const float* row = alpha_last + (size_t)b * S;
  const size_t obase = ((size_t)b * T + (T - 1)) * S;
  const float gb = gbar[b];
  float s = 0.f;
  for (int j = threadIdx.x; j < S; j += kRowThreads) s += row[j] * final_[j];
  const float zfin = fmaxf(block_sum<kRowThreads>(s, red), kTiny);
  float dot = 0.f;
  for (int j = threadIdx.x; j < S; j += kRowThreads)
    dot += gb * (final_[j] / zfin) * row[j];
  dot = block_sum<kRowThreads>(dot, red);
  const float ct = cs_last[b];
  for (int j = threadIdx.x; j < S; j += kRowThreads) {
    const float bar = gb * (final_[j] / zfin) - dot + gb;
    grad[obase + j] = row[j] * bar;
    vcar[(size_t)b * S + j] = (bar / ct) * expf(obs[obase + j]);
  }
}

// Frame t <= T-2: g = (sum of the split partials of v_{t+1} @ trans^T),
// then bar, grad_t and the carrier v_t.  g is parked in grad_t's row
// between the two passes.  One block per row.
__global__ void bwd_frame(const float* __restrict__ part, int splits,
                          const float* __restrict__ alpha_t,
                          const float* __restrict__ obs,
                          const float* __restrict__ cs_t,
                          const float* __restrict__ gbar, int t, int T, int B,
                          int S, float* __restrict__ grad,
                          float* __restrict__ vcar) {
  __shared__ float red[kRowThreads];
  const int b = blockIdx.x;
  const float* arow = alpha_t + (size_t)b * S;
  const size_t obase = ((size_t)b * T + t) * S;
  float* grow = grad + obase;
  float dot = 0.f;
  for (int j = threadIdx.x; j < S; j += kRowThreads) {
    float g = 0.f;
    for (int sp = 0; sp < splits; ++sp) g += part[((size_t)sp * B + b) * S + j];
    grow[j] = g;
    dot += g * arow[j];
  }
  dot = block_sum<kRowThreads>(dot, red);
  const float gb = gbar[b];
  const float ct = cs_t[b];
  for (int j = threadIdx.x; j < S; j += kRowThreads) {
    const float bar = grow[j] - dot + gb;
    grow[j] = arow[j] * bar;
    vcar[(size_t)b * S + j] = (bar / ct) * expf(obs[obase + j]);
  }
}

cudaError_t fwd_impl(const float* obs, const float* trans, const float* init,
                     const float* final_, float leaky, int B, int T, int S,
                     float* alphas, float* cs, float* logz, float* part,
                     cudaStream_t st) {
  const int kc = k_chunk(B, S);
  const int splits = num_splits(B, S);
  const dim3 grid((S + BN - 1) / BN, (B + BM - 1) / BM, splits);
  const size_t plane = (size_t)B * S;
  cudaError_t err;
  fwd_frame0<<<B, kRowThreads, 0, st>>>(obs, init, T, S, alphas, cs, logz);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int t = 1; t < T; ++t) {
    split_product<<<grid, kTileThreads, 0, st>>>(
        alphas + (size_t)(t - 1) * plane, init, leaky, trans, B, S, kc, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    fwd_normalize<<<B, kRowThreads, 0, st>>>(part, splits, obs, t, T, B, S,
                                             alphas + (size_t)t * plane,
                                             cs + (size_t)t * B, logz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  fwd_final<<<B, kRowThreads, 0, st>>>(alphas + (size_t)(T - 1) * plane,
                                       final_, S, logz);
  return cudaGetLastError();
}

cudaError_t bwd_impl(const float* obs, const float* trans_t,
                     const float* final_, const float* alphas, const float* cs,
                     const float* gbar, int B, int T, int S, float* grad,
                     float* vcar, float* part, cudaStream_t st) {
  const int kc = k_chunk(B, S);
  const int splits = num_splits(B, S);
  const dim3 grid((S + BN - 1) / BN, (B + BM - 1) / BM, splits);
  const size_t plane = (size_t)B * S;
  cudaError_t err;
  bwd_last<<<B, kRowThreads, 0, st>>>(alphas + (size_t)(T - 1) * plane, obs,
                                      final_, cs + (size_t)(T - 1) * B, gbar,
                                      T, S, grad, vcar);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int t = T - 2; t >= 0; --t) {
    split_product<<<grid, kTileThreads, 0, st>>>(vcar, nullptr, 0.f, trans_t,
                                                 B, S, kc, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_frame<<<B, kRowThreads, 0, st>>>(part, splits,
                                         alphas + (size_t)t * plane, obs,
                                         cs + (size_t)t * B, gbar, t, T, B, S,
                                         grad, vcar);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Number of K splits of the product (scratch sizing: part [splits, B, S]).
int dense_den_splits(int B, int S) { return num_splits(B, S); }

// Forward scan.  obs [B,T,S] f32 log observations; trans [S,S]; init and
// final [S].  Writes the normalized alphas [T,B,S], the scales cs [T,B]
// and logz [B].  Scratch: part [dense_den_splits(B, S), B, S].
int dense_den_fwd(const float* obs, const float* trans, const float* init,
                  const float* final_, float leaky, int B, int T, int S,
                  float* alphas, float* cs, float* logz, float* part,
                  void* stream) {
  return (int)fwd_impl(obs, trans, init, final_, leaky, B, T, S, alphas, cs,
                       logz, part, static_cast<cudaStream_t>(stream));
}

// Adjoint scan.  trans_t [S,S] is trans transposed (contiguous).  Writes
// grad [B,T,S] = d(sum_b gbar_b logz_b) / d obs.  Scratch: vcar [B,S],
// part [dense_den_splits(B, S), B, S].
int dense_den_bwd(const float* obs, const float* trans_t, const float* final_,
                  const float* alphas, const float* cs, const float* gbar,
                  int B, int T, int S, float* grad, float* vcar, float* part,
                  void* stream) {
  return (int)bwd_impl(obs, trans_t, final_, alphas, cs, gbar, B, T, S, grad,
                       vcar, part, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
