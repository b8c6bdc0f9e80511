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
//   t < T-1: g = v_{t+1} @ trans^T
//   bar = g - (g . alpha_t) + gbar,  grad_t = alpha_t * bar   (log-space)
//   v_t = (bar / c_t) * exp(obs_t)
//
// Precision: float32 accuracy throughout.  The Pallas kernel casts trans
// and alpha to bf16 when S*S*4 exceeds 12 MiB (`_mm_dtype`), because a
// float32 trans of the flagship's S = 2,208 (19.5 MB) does not fit the
// TPU's VMEM; that is a TPU workaround, and this port keeps float32 as the
// reference's XLA `forward_score` does.
//
// Layout.  Each direction is ONE persistent cooperative launch for the
// whole scan (after a memset of its barrier counter): 256 threads a block,
// one block per SM, every block resident, phases separated by a grid-wide
// barrier (about 1.3 us).  A frame's product is cut into tiles: the output
// dimension (trans's columns forward, its rows in the adjoint) in slices
// of 192 (8 warps x 3 n8 MMA tiles, each warp over all 64 rows of a row
// tile), the depth in n_depth slices of depth_w, n_out * n_depth <= #SMs
// (ops/dense_den_cuda._plan: 12 x 11 tiles of 192 x 208 at S = 2,208 on
// 132 SMs).  The whole of trans fits the card's combined shared memory
// there (19.5 MB against 132 x 227 KB), so each block copies its tile of
// trans ONCE per scan and keeps it for all T frames (kResident); a plan
// whose tile does not fit (S > 2,304 on 132 SMs) runs the same kernel with
// the tile read from global memory (L2) every frame and the A stage cut
// in depth chunks.  The adjoint reads the same trans with the tile
// transposed (trans rows as output), so no transposed copy exists.
//
//   Phase P (frame t), per tile and row tile of 64: the previous frame's
//   row (depth slice) is copied into shared memory with asynchronous
//   copies, multiplied by the tile on the tensor cores, and the tile's
//   depth partial stored: part[depth slice, b, out].  Barrier.
//   Phase R (frame t), one warp per (row, output slice) over all blocks:
//   the depth partials summed in slice order, then the frame's
//   elementwise work.  Barrier.
//
// Forward, deferred normalization: the product is linear, so frame t
// multiplies the UNNORMALIZED row a_{t-1}, and phase R applies the scale,
//     a_t = (sum_d part * 1/c_{t-1} + w) * exp(obs_t),
// w = (leaky*init) @ trans formed once per scan on the resident tiles;
// phase R also writes alphas[t-1] = a_{t-1} / c_{t-1}, and one partial row
// sum of a_t per output slice, from which every warp that needs c_t
// reduces it in one fixed order (the same bits everywhere).  So no pass
// exists only to normalize, and phase P is a copy and a product.
//
// Adjoint: phase R forms bar = (g - dot) + gbar, grad_t = alpha_t * bar and
// the carrier v_t = bar * 1/c_t * exp(obs_t) whole, so the next product's
// A stage is a plain copy too.  The row dot g_t . alpha_t is taken in the
// product's epilogue: each tile writes sum_n part[b, n] * alpha_t[b, n]
// over its columns, and phase R sums a row's per-tile dots in one order.
// (Finishing v in the next product's A stage instead, with the dot from
// phase R's per-slice partials, cost 20 us a frame of loads and exp in
// the A stage at the flagship shape: tools/dense_den_phases.py.)
//
// No atomics besides the barrier counter: runs repeat bit for bit.
// Per-row divisions are reciprocals; elementwise ops multiply.
//
// Product at float32 accuracy on the tensor cores (3xTF32), as in
// blocked_den.cu: each operand is split in registers, x = hi + lo, hi = x
// rounded to TF32 (two integer operations), lo = x - hi exactly, which the
// tensor cores truncate to TF32; mma.sync.m16n8k8 for lo*hi, hi*lo,
// hi*hi into float32 accumulators.  An output of depth K is within
// (2^-20 + 3K * 2^-24) * (|x| @ |w|) of the exact product.  wgmma cannot
// take the resident operand here: its 3xTF32 needs hi and lo planes of
// trans in shared memory, 39 MB, which does not fit.  Why not a SIMT
// float32 FMA main loop: at the float32 peak a frame's product at the
// flagship shape takes 9.3 us, a floor that a loop reading its operands
// from shared memory does not reach (the SIMT tiling these kernels
// replaced took 57 us a frame); this main loop takes about 10-11 us a
// frame (tools/dense_den_phases.py, base against no_mainloop; PERF.md).
//
// What bounds it on an H100: 2*B*S*S = 0.62 GFLOP of product per flagship
// frame (B = 64): 0.46 ms a 50-frame scan at the 67 TFLOP/s float32 rate;
// on the unit it runs on, three TF32 passes at the 495 TFLOP/s dense TF32
// rate, 0.19 ms; memory is no bound (obs, alphas, trans once: 0.07 ms).
// Per frame and SM the resident design moves the A stage (53 KB) and the
// partials (49 KB written, as much read) through L2 instead of the
// 19.5 MB trans.
// What holds it back is in PERF.md (tools/dense_den_phases.py): the
// mma.sync rate of three TF32 passes, the split-K partials' round trip
// through L2 and two barriers a frame.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kTiny = 1e-30f;
constexpr int kThreads = 256;  // 8 warps, each over all 64 rows
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64;                   // batch rows per row tile
constexpr int MT = BM / 16;              // m16 tiles per warp
constexpr int NT = 3;                    // n8 tiles per warp
constexpr int kOutW = kWarps * NT * 8;   // output columns per tile: 192
constexpr int kCols = kOutW / 32;        // columns per lane in phase R
constexpr int kSmall = BM * kWarps;      // the adjoint epilogue's reduction
constexpr int kAlphaLd = kOutW + 4;      // alpha_t's tile in the A stage
constexpr int kPad = 64;                 // scratch sections on 256 bytes

static_assert(kCols * 32 == kOutW, "phase R lane tiling");

// ------------------------------------------------------------ primitives

// Grid-wide barrier of a cooperative launch: per barrier the blocks add
// 2^31 in all to one counter (block 0 adds 2^31 - (grid - 1), the others
// 1), so its top bit flips once every block has arrived.  The counter's
// low 31 bits start at zero and return to it after every barrier.
__device__ __forceinline__ void grid_sync(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(counter, add);
    volatile unsigned int* vc = counter;
    while (((old ^ *vc) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// x = hi + lo: hi = x rounded to TF32 (nearest, ties away, as cvt.rna
// rounds, in two integer operations), lo = x - hi exactly, handed to the
// tensor cores as it is (they read its top 19 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte copy global -> shared; zero-fills when !valid (src not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Sum over the warp, the same bits in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Sum of n values written earlier in this launch (read through L2), in one
// fixed order per warp: lane-strided, then the butterfly.  Every warp that
// sums the same values gets the same bits.
__device__ __forceinline__ float warp_sum_of(const float* p, int n) {
  float s = 0.f;
  for (int i = threadIdx.x & 31; i < n; i += 32) s += __ldcg(p + i);
  return warp_sum(s);
}

// ------------------------------------------------------------- arguments

struct Args {
  const float* obs;       // [B, T, S] log observations
  const float* trans;     // [S, S]
  const float* init;      // [S] (forward)
  const float* final_;    // [S]
  const float* alpha_in;  // [T, B, S] normalized alphas (adjoint)
  const float* cs_in;     // [T, B] (adjoint)
  const float* gbar;      // [B] (adjoint)
  float leaky;
  int B, T, S;
  int n_out, depth_w, n_depth, chunk;  // the plan
  float* alphas;          // [T, B, S] (forward)
  float* cs;              // [T, B] (forward)
  float* logz;            // [B] (forward)
  float* grad;            // [B, T, S] (adjoint)
  unsigned int* counter;  // barrier, zeroed
  float* part;            // [n_depth, B, S] product partials
  float* plane;           // [B, S] forward: unnormalized a; adjoint: v
  float* rpart;           // forward [2][B, n_out] row sums by frame
                          // parity; adjoint [B, n_out * n_depth] dots
  float* wpart;           // forward [n_depth, S] partials of w
  float* wvec;            // forward [S] w = (leaky*init) @ trans
};

// Element (depth k, output n) of the product's right operand, from global
// memory: trans[k][n] forward; the adjoint reads trans transposed,
// trans[n][k].
template <bool kFwd>
__device__ __forceinline__ float load_m(const Args& p, int k, int n) {
  if (k >= p.S || n >= p.S) return 0.f;
  return kFwd ? __ldg(p.trans + (size_t)k * p.S + n)
              : __ldg(p.trans + (size_t)n * p.S + k);
}

__device__ __forceinline__ int tile_ld(bool fwd, int depth_w) {
  return fwd ? kOutW + 8 : depth_w + 4;  // conflict-free fragment reads
}

// Block's resident tile of trans, copied once: forward [depth_w][kOutW]
// (trans rows = depth), adjoint [kOutW][depth_w] (trans rows = output);
// zeros past S.
template <bool kFwd>
__device__ void load_tile(const Args& p, int tl, float* tile) {
  const int d = tl / p.n_out, j = tl - d * p.n_out;
  const int rows_t = kFwd ? p.depth_w : kOutW;
  const int cols_t = kFwd ? kOutW : p.depth_w;
  const int gr0 = kFwd ? d * p.depth_w : j * kOutW;  // first row of trans
  const int gc0 = kFwd ? j * kOutW : d * p.depth_w;  // first column
  const int ld = tile_ld(kFwd, p.depth_w);
  const bool vec = (p.S & 3) == 0;
  const int cols4 = cols_t / 4;
  for (int e = threadIdx.x; e < rows_t * cols4; e += kThreads) {
    const int r = e / cols4, c = (e - r * cols4) * 4;
    const int gr = gr0 + r, gc = gc0 + c;
    float* dst = tile + r * ld + c;
    const float* src = p.trans + (size_t)gr * p.S + gc;
    if (vec) {
      const bool ok = gr < p.S && gc < p.S;
      cp_async16(dst, ok ? src : p.trans, ok);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (gr < p.S && gc + q < p.S)
          cp_async4(dst + q, src + q);
        else
          dst[q] = 0.f;
      }
    }
  }
  cp_async_commit();
  cp_async_wait_all();
}

// ------------------------------------------------------------- phase P

// Floats of the A-stage region: the A stage [BM][chunk + 4], which the
// adjoint's epilogue reuses for alpha_t's tile [BM][kAlphaLd].
__host__ __device__ __forceinline__ int stage_floats(int chunk) {
  return BM * (chunk + 4 > kAlphaLd ? chunk + 4 : kAlphaLd);
}

// Asynchronous copy of plane rows [r0, r0 + rows) x columns [c0, c1) into
// the A stage (row stride lda); columns up to the next multiple of 8 are
// zeroed.  The caller waits and syncs.
__device__ void stage_copy(const Args& p, int r0, int rows, int c0, int c1,
                           float* as, int lda) {
  const int w = c1 - c0;
  if ((p.S & 3) == 0) {  // w is a multiple of 4 then
    const int q4 = w / 4;
    for (int e = threadIdx.x; e < rows * q4; e += kThreads) {
      const int r = e / q4, c = (e - r * q4) * 4;
      cp_async16(as + r * lda + c,
                 p.plane + (size_t)(r0 + r) * p.S + c0 + c, true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += kThreads) {
      const int r = e / w, c = e - r * w;
      cp_async4(as + r * lda + c, p.plane + (size_t)(r0 + r) * p.S + c0 + c);
    }
  }
  for (int e = threadIdx.x; e < rows * 8; e += kThreads) {
    const int r = e >> 3, c = (w & ~3) + (e & 7);
    if (c >= w && c < ((w + 7) & ~7)) as[r * lda + c] = 0.f;
  }
  cp_async_commit();
}

// acc += A stage (rows x depth8) @ right operand (depth8 x this warp's 24
// output columns), 3xTF32.  Resident: the tile in shared memory (row
// stride ldt, from depth tk0); else global memory from depth gk0.  The
// next step's operands are read before this step's MMAs are issued.
template <bool kFwd, bool kResident>
__device__ __forceinline__ void mainloop(const Args& p, const float* as,
                                         int lda, const float* tile, int ldt,
                                         int depth8, int o0, int gk0,
                                         int rows, float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int live = (rows + 15) >> 4;  // m16 tiles holding rows
  float ra[MT][4], rb[NT][2];
  auto fetch = [&](int kk) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < live) {
        const float* ap = as + (i * 16 + g) * lda + kk + t4;
        ra[i][0] = ap[0];
        ra[i][1] = ap[8 * lda];
        ra[i][2] = ap[4];
        ra[i][3] = ap[8 * lda + 4];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = warp * (NT * 8) + j * 8 + g;
      if (kResident) {
        if (kFwd) {
          rb[j][0] = tile[(kk + t4) * ldt + n];
          rb[j][1] = tile[(kk + t4 + 4) * ldt + n];
        } else {
          rb[j][0] = tile[n * ldt + kk + t4];
          rb[j][1] = tile[n * ldt + kk + t4 + 4];
        }
      } else {
        rb[j][0] = load_m<kFwd>(p, gk0 + kk + t4, o0 + n);
        rb[j][1] = load_m<kFwd>(p, gk0 + kk + t4 + 4, o0 + n);
      }
    }
  };
  fetch(0);
  for (int kk = 0; kk < depth8; kk += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < live)
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(ra[i][q], ah[i][q], al[i][q]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) split_tf32(rb[j][q], bh[j][q], bl[j][q]);
    if (kk + 8 < depth8) fetch(kk + 8);
    // the three passes in turn over all (i, j), so that consecutive
    // mma.sync never wait on the same accumulator
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < live)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < live)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < live)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
  }
}

// acc = A @ tile tl for one row tile of `rows` rows: fill(c0, c1, as, lda)
// starts the A stage for depth columns [c0, c1) (asynchronous copies,
// waited for here), then the product over that chunk.
template <bool kFwd, bool kResident, typename Fill>
__device__ void tile_product(const Args& p, int tl, int rows, float* as,
                             const float* tile, Fill fill,
                             float (&acc)[MT][NT][4]) {
  const int lda = p.chunk + 4;
  const int d = tl / p.n_out, j = tl - d * p.n_out;
  const int d0 = d * p.depth_w, d1 = min(p.S, d0 + p.depth_w);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][jj][q] = 0.f;
  fill(d0, min(d1, d0 + p.chunk), as, lda);
  for (int c0 = d0; c0 < d1; c0 += p.chunk) {
    const int c1 = min(d1, c0 + p.chunk);
    cp_async_wait_all();
    __syncthreads();
    mainloop<kFwd, kResident>(p, as, lda, tile, tile_ld(kFwd, p.depth_w),
                             (c1 - c0 + 7) & ~7, j * kOutW, c0, rows, acc);
    __syncthreads();
    if (c1 < d1) fill(c1, min(d1, c1 + p.chunk), as, lda);
  }
}

// Calls f(i, j, q, r, n) for each accumulator element acc[i][j][q] of the
// calling thread, r its row in the row tile, n its column in the tile.
template <typename F>
__device__ __forceinline__ void for_each_frag(F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(i, j, q, i * 16 + (q >> 1) * 8 + g,
          warp * (NT * 8) + j * 8 + 2 * t4 + (q & 1));
}

// dst[r * S + o0 + n] = acc for rows r < rows and columns o0 + n < S, 8
// bytes a store where S is even.
__device__ void store_tile(const Args& p, float* dst, int rows, int o0,
                           float (&acc)[MT][NT][4]) {
  const bool vec = (p.S & 1) == 0;
  for_each_frag([&](int i, int j, int q, int r, int n) {
    n += o0;
    if ((q & 1) || r >= rows || n >= p.S) return;  // pairs (n, n + 1)
    float* out = dst + (size_t)r * p.S + n;
    if (vec) {
      *reinterpret_cast<float2*>(out) =
          make_float2(acc[i][j][q], acc[i][j][q + 1]);
    } else {
      out[0] = acc[i][j][q];
      if (n + 1 < p.S) out[1] = acc[i][j][q + 1];
    }
  });
}

// Adjoint epilogue, first half: asynchronous copies of alpha_t's rows
// [r0, r0 + rows) x columns [o0, o0 + 192) into the A stage (free after
// the product; row stride kAlphaLd), zeros past S; 16 bytes a copy where
// S is a multiple of 4 and alphas lie on 16 bytes.
__device__ void bwd_stage_alpha(const Args& p, int t, int r0, int rows,
                                int o0, float* as) {
  const float* al = p.alpha_in + ((size_t)t * p.B + r0) * p.S;
  if ((p.S & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(p.alpha_in) & 15) == 0) {
    constexpr int q4 = kOutW / 4;
#pragma unroll 1  // unrolled, the adjoint spills more registers (ptxas)
    for (int e = threadIdx.x; e < rows * q4; e += kThreads) {
      const int r = e / q4, n = (e - r * q4) * 4;
      const bool ok = o0 + n < p.S;
      cp_async16(as + r * kAlphaLd + n,
                 ok ? al + (size_t)r * p.S + o0 + n : al, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kOutW; e += kThreads) {
      const int r = e / kOutW, n = e - r * kOutW;
      if (o0 + n < p.S)
        cp_async4(as + r * kAlphaLd + n, al + (size_t)r * p.S + o0 + n);
      else
        as[r * kAlphaLd + n] = 0.f;
    }
  }
  cp_async_commit();
}

// Adjoint epilogue, second half: the tile's partial row dots sum_n acc[r,
// n] * alpha_t[r0 + r, o0 + n] (fixed order: the thread's columns, the
// quad by shuffles, the 8 warps in turn through red [BM][kWarps]) into
// rpart[r0 + r, tl].
__device__ void bwd_tile_dots(const Args& p, int tl, int r0, int rows,
                              const float* as, float (&acc)[MT][NT][4],
                              float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cp_async_wait_all();
  __syncthreads();
  float rs[MT][2] = {};
  for_each_frag([&](int i, int j, int q, int r, int n) {
    rs[i][q >> 1] += acc[i][j][q] * as[r * kAlphaLd + n];
  });
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rs[i][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0)
        red[(i * 16 + h * 8 + (lane >> 2)) * kWarps + warp] = v;
    }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[r * kWarps + w];
    p.rpart[(size_t)(r0 + r) * p.n_out * p.n_depth + tl] = s;
  }
  __syncthreads();
}

// Phase P: the product of frame t (forward: from a_{t-1}; adjoint: from
// v_{t+1}), each tile's depth partials into part; the adjoint's tiles
// also write their partial row dots with alpha_t.
template <bool kFwd, bool kResident>
__device__ void products(const Args& p, int t, float* small, float* as,
                         const float* tile) {
  const int ntiles = p.n_out * p.n_depth;
  for (int tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    const int d = tl / p.n_out, o0 = (tl - d * p.n_out) * kOutW;
    for (int r0 = 0; r0 < p.B; r0 += BM) {
      const int rows = min(BM, p.B - r0);
      float acc[MT][NT][4];
      tile_product<kFwd, kResident>(
          p, tl, rows, as, tile,
          [&](int c0, int c1, float* a, int lda) {
            stage_copy(p, r0, rows, c0, c1, a, lda);
          },
          acc);
      if (!kFwd) bwd_stage_alpha(p, t, r0, rows, o0, as);
      store_tile(p, p.part + ((size_t)d * p.B + r0) * p.S, rows, o0, acc);
      if (!kFwd) bwd_tile_dots(p, tl, r0, rows, as, acc, small);
    }
  }
}

// Forward, once per scan: the depth partials of w = (leaky*init) @ trans
// (a one-row product on the same tiles) into wpart.
template <bool kResident>
__device__ void fwd_leaky_partials(const Args& p, float* as,
                                   const float* tile) {
  const int ntiles = p.n_out * p.n_depth;
  for (int tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    const int d = tl / p.n_out;
    float acc[MT][NT][4];
    tile_product<true, kResident>(
        p, tl, 1, as, tile,
        [&](int c0, int c1, float* a, int) {
          for (int c = threadIdx.x; c < ((c1 - c0 + 7) & ~7); c += kThreads)
            a[c] = c0 + c < c1 ? p.leaky * __ldg(p.init + c0 + c) : 0.f;
        },
        acc);
    store_tile(p, p.wpart + (size_t)d * p.S, 1, (tl - d * p.n_out) * kOutW,
               acc);
  }
}

// ------------------------------------------------------------- phase R

// Calls f(b, j, n0) for each (row, output slice) item of this warp.
template <typename F>
__device__ __forceinline__ void for_each_item(const Args& p, F f) {
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nw = gridDim.x * kWarps;
  for (int item = gw; item < p.B * p.n_out; item += nw) {
    const int b = item / p.n_out, j = item - b * p.n_out;
    f(b, j, j * kOutW);
  }
}

// x[u] = sum over the depth slices (in order) of src[d * stride + n0 +
// 32u + lane].  The loads of up to kBatch slices are issued together.
constexpr int kBatch = 12;

__device__ __forceinline__ void sum_partials(const Args& p, const float* src,
                                             size_t stride, int n0,
                                             float (&x)[kCols]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kCols; ++u) x[u] = 0.f;
  for (int d0 = 0; d0 < p.n_depth; d0 += kBatch) {
    float y[kBatch][kCols];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        y[k][u] = d0 + k < p.n_depth
                      ? __ldcg(src + (d0 + k) * stride +
                               min(n0 + u * 32 + lane, p.S - 1))
                      : 0.f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (d0 + k < p.n_depth) x[u] += y[k][u];
  }
}

// Forward, frame t.  t = 0: a_0 = init * exp(obs_0) (and w reduced from
// its partials by the items of row 0).  t > 0: c_{t-1} from the previous
// frame's per-slice row sums, alphas[t-1] = a_{t-1} / c_{t-1} (and cs by
// slice 0), a_t = (sum of the partials / c_{t-1} + w) * exp(obs_t).  Then
// a_t into plane and its per-slice row sum into rpart[t % 2].
__device__ void fwd_rows(const Args& p, int t) {
  const int lane = threadIdx.x & 31;
  const bool leaky = p.leaky > 0.f;
  for_each_item(p, [&](int b, int j, int n0) {
    float* row = p.plane + (size_t)b * p.S;
    float x[kCols], o[kCols], w[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int n = min(n0 + u * 32 + lane, p.S - 1);
      o[u] = __ldg(p.obs + ((size_t)b * p.T + t) * p.S + n);
      w[u] = leaky && t > 0 ? __ldcg(p.wvec + n) : 0.f;
    }
    if (t == 0) {
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        x[u] = __ldg(p.init + min(n0 + u * 32 + lane, p.S - 1));
      if (leaky && b == 0) {
        float wv[kCols];
        sum_partials(p, p.wpart, p.S, n0, wv);
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          if (n0 + u * 32 + lane < p.S) p.wvec[n0 + u * 32 + lane] = wv[u];
      }
    } else {
      const float* prev =
          p.rpart + ((size_t)((t - 1) & 1) * p.B + b) * p.n_out;
      const float c = fmaxf(warp_sum_of(prev, p.n_out), kTiny);
      const float rc = __frcp_rn(c);
      float al[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        al[u] = __ldcg(row + min(n0 + u * 32 + lane, p.S - 1));
      sum_partials(p, p.part + (size_t)b * p.S, (size_t)p.B * p.S, n0, x);
      float* out = p.alphas + ((size_t)(t - 1) * p.B + b) * p.S;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int n = n0 + u * 32 + lane;
        if (n < p.S) out[n] = al[u] * rc;
        x[u] = x[u] * rc + w[u];
      }
      if (j == 0 && lane == 0) p.cs[(size_t)(t - 1) * p.B + b] = c;
    }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int n = n0 + u * 32 + lane;
      if (n < p.S) {
        const float a = x[u] * expf(o[u]);
        row[n] = a;
        s += a;
      }
    }
    s = warp_sum(s);
    if (lane == 0)
      p.rpart[((size_t)(t & 1) * p.B + b) * p.n_out + j] = s;
  });
}

// After the last frame: alphas[T-1] = a / c, cs[T-1], and (slice 0 of
// each row) logz = sum_t log c_t + log max(alpha_{T-1} . final, 1e-30).
__device__ void fwd_finish(const Args& p) {
  const int lane = threadIdx.x & 31;
  const int t = p.T - 1;
  for_each_item(p, [&](int b, int j, int n0) {
    const float c = fmaxf(
        warp_sum_of(p.rpart + ((size_t)(t & 1) * p.B + b) * p.n_out,
                    p.n_out),
        kTiny);
    const float rc = __frcp_rn(c);
    const float* ar = p.plane + (size_t)b * p.S;
    float* out = p.alphas + ((size_t)t * p.B + b) * p.S;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int n = n0 + u * 32 + lane;
      if (n < p.S) out[n] = __ldcg(ar + n) * rc;
    }
    if (j != 0) return;
    float zf = 0.f;
#pragma unroll 8
    for (int n = lane; n < p.S; n += 32)
      zf += __ldcg(ar + n) * __ldg(p.final_ + n);
    zf = warp_sum(zf);
    float z = 0.f;
    for (int u = lane; u < t; u += 32)
      z += logf(__ldcg(p.cs + (size_t)u * p.B + b));
    z = warp_sum(z);
    if (lane == 0) {
      p.cs[(size_t)t * p.B + b] = c;
      p.logz[b] = (z + logf(c)) + logf(fmaxf(zf * rc, kTiny));
    }
  });
}

// Adjoint outputs of frame t for the lane's columns of one item: bar =
// (g - dot) + gbar, grad_t = alpha_t * bar and, for t > 0, the carrier
// v_t = bar * 1/c_t * exp(obs_t) into plane.
__device__ __forceinline__ void bwd_emit(const Args& p, int t, int b, int n0,
                                         const float (&g)[kCols],
                                         const float (&a)[kCols],
                                         const float (&o)[kCols], float dot) {
  const int lane = threadIdx.x & 31;
  const float gb = __ldg(p.gbar + b);
  const float rc = __frcp_rn(__ldg(p.cs_in + (size_t)t * p.B + b));
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int n = n0 + u * 32 + lane;
    if (n >= p.S) continue;
    const float bar = (g[u] - dot) + gb;
    p.grad[((size_t)b * p.T + t) * p.S + n] = a[u] * bar;
    if (t > 0) p.plane[(size_t)b * p.S + n] = bar * rc * expf(o[u]);
  }
}

// alpha_t and obs_t at the lane's columns of an item.
__device__ __forceinline__ void bwd_row_inputs(const Args& p, int t, int b,
                                               int n0, float (&a)[kCols],
                                               float (&o)[kCols]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int n = min(n0 + u * 32 + lane, p.S - 1);
    a[u] = __ldg(p.alpha_in + ((size_t)t * p.B + b) * p.S + n);
    o[u] = __ldg(p.obs + ((size_t)b * p.T + t) * p.S + n);
  }
}

// Adjoint, frame T-1: zfin = max(S_f, 1e-30) with S_f = alpha_{T-1} .
// final (each warp sums the whole row in one order: the same bits in
// all), g = gbar * final / zfin, dot = gbar * S_f / zfin, then the
// frame's outputs.
__device__ void bwd_first(const Args& p) {
  const int lane = threadIdx.x & 31;
  const int t = p.T - 1;
  for_each_item(p, [&](int b, int, int n0) {
    const float* al = p.alpha_in + ((size_t)t * p.B + b) * p.S;
    float a[kCols], o[kCols], g[kCols];
    bwd_row_inputs(p, t, b, n0, a, o);
    float sf = 0.f;
#pragma unroll 8
    for (int n = lane; n < p.S; n += 32)
      sf += __ldg(al + n) * __ldg(p.final_ + n);
    sf = warp_sum(sf);
    const float rz = __frcp_rn(fmaxf(sf, kTiny));
    const float gb = __ldg(p.gbar + b);
#pragma unroll
    for (int u = 0; u < kCols; ++u)
      g[u] = (gb * __ldg(p.final_ + min(n0 + u * 32 + lane, p.S - 1))) * rz;
    bwd_emit(p, t, b, n0, g, a, o, (gb * sf) * rz);
  });
}

// Adjoint, frame t < T-1: g = the sum of the depth partials, dot = the
// sum of the row's per-tile partial dots, then the frame's outputs.
__device__ void bwd_rows(const Args& p, int t) {
  const int ntiles = p.n_out * p.n_depth;
  for_each_item(p, [&](int b, int, int n0) {
    float a[kCols], o[kCols], g[kCols];
    bwd_row_inputs(p, t, b, n0, a, o);
    const float dot = warp_sum_of(p.rpart + (size_t)b * ntiles, ntiles);
    sum_partials(p, p.part + (size_t)b * p.S, (size_t)p.B * p.S, n0, g);
    bwd_emit(p, t, b, n0, g, a, o, dot);
  });
}

// ------------------------------------------------------------ the kernel

template <bool kFwd, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) scan(Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* small = smem;                          // [kSmall]
  float* as = smem + kSmall;                    // [BM][chunk + 4]
  float* tile = as + stage_floats(p.chunk);     // resident tile
  if (kResident && blockIdx.x < p.n_out * p.n_depth)
    load_tile<kFwd>(p, blockIdx.x, tile);
  if (kFwd) {
    if (p.leaky > 0.f) {
      fwd_leaky_partials<kResident>(p, as, tile);
      grid_sync(p.counter);
    }
    fwd_rows(p, 0);
  } else {
    bwd_first(p);
  }
  for (int s = 1; s < p.T; ++s) {
    const int t = kFwd ? s : p.T - 1 - s;
    grid_sync(p.counter);
    products<kFwd, kResident>(p, t, small, as, tile);
    grid_sync(p.counter);
    if (kFwd)
      fwd_rows(p, t);
    else
      bwd_rows(p, t);
  }
  if (kFwd) {
    grid_sync(p.counter);
    fwd_finish(p);
  }
}

// ------------------------------------------------------------------ host

size_t pad_up(size_t n) { return (n + kPad - 1) / kPad * kPad; }

struct Layout {
  size_t part, plane, rpart, wpart, wvec, total;
};

Layout layout(int B, int S, int n_out, int n_depth) {
  const size_t rp = (size_t)B * (n_depth > 2 ? n_depth : 2) * n_out;
  Layout l;
  l.part = kPad;  // after the barrier counter
  l.plane = l.part + pad_up((size_t)n_depth * B * S);
  l.rpart = l.plane + pad_up((size_t)B * S);
  l.wpart = l.rpart + pad_up(rp);
  l.wvec = l.wpart + pad_up((size_t)n_depth * S);
  l.total = l.wvec + pad_up(S);
  return l;
}

// A block's dynamic shared memory, the same for both directions: the small
// area, the A stage and, resident, the larger of the two tile layouts
// (forward [depth_w][kOutW + 8], adjoint [kOutW][depth_w + 4]).
size_t smem_bytes(int chunk, int depth_w, bool resident) {
  size_t f = kSmall + stage_floats(chunk);
  if (resident) {
    const size_t fwd = (size_t)depth_w * (kOutW + 8);
    const size_t bwd = (size_t)kOutW * (depth_w + 4);
    f += fwd > bwd ? fwd : bwd;
  }
  return f * sizeof(float);
}

// The plan's invariants (ops/dense_den_cuda._plan makes it).
bool plan_ok(const Args& p, bool resident) {
  return p.B >= 1 && p.T >= 1 && p.S >= 1 &&
         p.n_out == (p.S + kOutW - 1) / kOutW && p.depth_w >= 8 &&
         p.depth_w % 8 == 0 &&
         p.n_depth == (p.S + p.depth_w - 1) / p.depth_w && p.chunk >= 8 &&
         p.chunk % 8 == 0 && p.chunk <= p.depth_w &&
         (!resident || p.chunk == p.depth_w);
}

// Above the device's opt-in limit, cudaFuncSetAttribute refuses the size.
template <bool kFwd, bool kResident>
cudaError_t launch(Args p, float* scratch, cudaStream_t st) {
  if (!plan_ok(p, kResident)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.chunk, p.depth_w, kResident);
  const Layout l = layout(p.B, p.S, p.n_out, p.n_depth);
  p.counter = reinterpret_cast<unsigned int*>(scratch);
  p.part = scratch + l.part;
  p.plane = scratch + l.plane;
  p.rpart = scratch + l.rpart;
  p.wpart = scratch + l.wpart;
  p.wvec = scratch + l.wvec;
  auto kernel = scan<kFwd, kResident>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  const int grid = per_sm * sms;
  // a resident tile is copied once: every tile needs a block of its own
  if (per_sm < 1 || (kResident && grid < p.n_out * p.n_depth))
    return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(scratch, 0, sizeof(unsigned int), st)) !=
      cudaSuccess)
    return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, kThreads,
                                     args, smem, st);
}

}  // namespace

extern "C" {

// Floats of scratch either direction needs for a plan of n_out x n_depth
// tiles.
long long dense_den_scratch(int B, int S, int n_out, int n_depth) {
  return (long long)layout(B, S, n_out, n_depth).total;
}

// Bytes of dynamic shared memory a block of either direction takes for an
// A-stage chunk, a depth slice of depth_w and a resident tile or not
// (ops/dense_den_cuda._device_plan plans with it).
long long dense_den_smem_bytes(int chunk, int depth_w, int resident) {
  return (long long)smem_bytes(chunk, depth_w, resident != 0);
}

// Dynamic shared memory a block may opt in to on the current device, in
// bytes; a negative CUDA error code on failure.
int dense_den_smem_limit() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -(int)err;
}

// Forward scan.  obs [B,T,S] f32 log observations; trans [S,S]; init and
// final [S]; the plan (n_out output slices of 192, n_depth depth slices of
// depth_w, A-stage chunk, resident tile or not) from
// ops/dense_den_cuda._plan.  Writes the normalized alphas [T,B,S], the
// scales cs [T,B] and logz [B].  scratch: dense_den_scratch(...) floats.
// One memset and one cooperative launch on `stream`; no host sync, no
// allocation.
int dense_den_fwd(const float* obs, const float* trans, const float* init,
                  const float* final_, float leaky, int B, int T, int S,
                  int n_out, int depth_w, int n_depth, int chunk,
                  int resident, float* alphas, float* cs, float* logz,
                  float* scratch, void* stream) {
  Args p{obs, trans, init, final_, nullptr, nullptr, nullptr, leaky, B, T,
         S, n_out, depth_w, n_depth, chunk, alphas, cs, logz, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(resident ? launch<true, true>(p, scratch, st)
                        : launch<true, false>(p, scratch, st));
}

// Adjoint scan.  trans [S,S] as the forward takes it, read with the tile
// transposed.  Writes grad [B,T,S] = d(sum_b gbar_b logz_b) / d obs.  Plan
// and scratch as for the forward.
int dense_den_bwd(const float* obs, const float* trans, const float* final_,
                  const float* alphas, const float* cs, const float* gbar,
                  int B, int T, int S, int n_out, int depth_w, int n_depth,
                  int chunk, int resident, float* grad, float* scratch,
                  void* stream) {
  Args p{obs, trans, nullptr, final_, alphas, cs, gbar, 0.f, B, T, S, n_out,
         depth_w, n_depth, chunk, nullptr, nullptr, nullptr, grad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(resident ? launch<false, true>(p, scratch, st)
                        : launch<false, false>(p, scratch, st));
}

}  // extern "C"
