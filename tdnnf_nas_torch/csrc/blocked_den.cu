// Blocked LF-MMI denominator scan: forward and exact adjoint, for Hopper.
//
// Replaces the Pallas pair `_blk_fwd_kernel` / `_blk_bwd_kernel`
// (tdnnf_nas_tpu/ops/pallas_fwdbwd.py) and computes what the XLA twin
// `_blocked_score_core` (tdnnf_nas_tpu/ops/fwdbwd.py) computes.  Layout per
// superblock c (C superblocks, NDP = R*NDPOS + NSRC slots, V = C*NDP):
//
//     [ R*NDPOS enter slots, r-major (slot r*NDPOS + i) | NSRC loop slots ]
//
// Each direction is ONE persistent cooperative launch for the whole scan
// (after a memset of its scratch): 256 threads and 200 KB of shared memory
// a block, so one block per SM and every block resident; phases are
// separated by a grid-wide barrier (about 1.5 us on an H100).
//
// Forward.  Phase P (frame t): each block takes output tiles of 64 batch
// rows x 160 columns of one superblock (7 x 17 = 119 tiles at the
// flagship shape, one wave on 132 SMs), runs the block product
// a = beta_c @ W_c on the tensor cores, multiplies by obs_t (f32 or bf16,
// upcast in registers), writes the unnormalized tile and one partial row
// sum per tile.  Barrier.  Phase G (frame t -> t+1), per half row: the row
// (75 KB) is staged into shared memory with asynchronous copies while the
// row's scale c_t is reduced from the partials in one fixed order (every
// block gets the same bits), then alphas[t] = a / c_t and, with 1/c_t
// folded in (deferred normalization: no pass exists only to normalize),
//     beta[j] = (sum_r a[enter(perm[j], r)] + a[loop j]) / c_t
//               + leaky * init_pos[j],
// the permutation read from shared memory, not gathered from L2.
//
// Adjoint.  Phase P (frame t): tiles of 64 rows x 160 sources of
// u = v @ W_c^T, split over d into S partial sums (S fills the SMs: 28
// tiles x 4 splits at the flagship shape), W read along d (coalesced).
// The row dot g_t . alpha_t needs no pass of its own: with L^T v = the
// assembly of u through perm_inv, and perm_inv the inverse of perm,
//     sum_v (L^T v)[v] alpha_t[v] = sum_j u[j] beta0_t[j],
// beta0_t the forward's gather of alpha_t without the leaky term, so each
// tile's epilogue writes a partial dot beside its partial u.  Barrier.
// Phase F, per half row: u (the S partials summed in order) and alpha_{t-1}
// staged in shared memory; per element the inverse permutation (sentinel
// C*NSRC reads zero), the broadcast to the R enter slots and the loop
// slice, bar = g - dot + gbar, grad_obs = alpha*bar / max(obs, 1e-30) in
// obs's dtype and the carrier v_t = (bar / c_t) * obs_t; then beta0 of
// frame t-1.  Barrier.  Row passes issue each thread's global loads
// together before any use: a warp issues in order and stalls at the first
// use of a pending load.
//
// Product at float32 accuracy on the tensor cores (3xTF32).  Each operand
// is split in registers, x = hi + lo: hi = x rounded to TF32 (to nearest,
// in two integer operations: cvt.rna runs at a fraction of the ALU rate
// and cost about 5 us of the forward's 43 us product phase), lo = x - hi
// exactly, which the tensor cores truncate to TF32.  A k8 step issues
// mma.sync.m16n8k8 for lo*hi, hi*lo, hi*hi into float32 accumulators, each
// pass over all fragments in turn.  The dropped lo*lo
// term and the truncation of lo leave a relative error per product of at
// most about 2^-20 (9.5e-7); accumulation is float32, so an output of
// depth K is within (2^-20 + 3K * 2^-24) * (|x| @ |w|) of the exact
// product, as close as a float32 product comes (tested on the CPU through
// ops/blocked_den_cuda.split_tf32_matmul).  One TF32 pass would leave
// 2^-11.
//
// What bounds it on an H100: per frame 2*B*C*NSRC*NDP = 1.3 GFLOP at the
// flagship shape (B=64, C=7, NSRC=538, NDP=2690): 0.95 ms a 49-frame scan
// at the 67 TFLOP/s float32 rate, 0.39 ms as three TF32 passes at 495.
// Obs, alphas and W moved once take 0.12-0.16 ms at 3.35 TB/s.  W (rows
// padded to 16 bytes once per graph) streams through a 4-stage ring of
// 16-byte cp.async copies (129 KB) every frame; none of it stays resident
// across frames, since a 64 x 160 tile needs 344 KB of W.  At the flagship
// W is 40.5 MB and each frame finds it in the 50 MB L2.  At a committed +-1
// graph's shape (C=22, NSRC=556, NDP=2796) it is 136.8 MB: it no longer
// fits L2, so each frame streams it from device memory (2.0 ms over a
// 49-frame scan at 3.35 TB/s), which sets the 3xTF32 bound there (the
// float32 rate's 3.2 ms does not change).  What holds it back at the
// flagship (tools/blocked_den_phases.py, per frame): the
// product's main loop, 27 us forward and 35 us adjoint, bound by the
// mma.sync rate of three TF32 passes (one pass saves 7 and 11 us) and by
// the W stream (no copies saves 4 and 10 us), which overlap only in part
// with one block of 8 warps a SM; the epilogue and barrier 7.5 us; the row
// passes 7 us forward and 16 us adjoint, plus a 1.5 us barrier each.
// wgmma (twice the mma.sync rate) fed by TMA, and keeping the next frame's
// W in flight across the barriers, are the next steps.
//
// A row that does not fit the row passes' shared memory (V > 51,196
// floats, the +-1 shape's 61,512 among them) is read through L2 in place
// (__ldcg: the products were written by other blocks in this launch) with
// the same arithmetic.
//
// The wildcard (rank-R broadcast) term of committed +-1 graphs, for R <=
// kMaxR groups, each source slot in at most one group (gid[j], -1 = none),
// each group with its shared out-row vec[g] [V]:
//   forward  a += (beta @ sel) @ vec: phase G sums each group's betas over
//            its part of the row (per thread in slot order, then a block
//            sum) into wpart[b][h][g]; the product epilogue adds
//            sum_g (sum_h wpart) * vec[g][col] before the obs multiply;
//   adjoint  u += (v @ vec^T) @ sel^T: phase F sums z[g] = v . vec[g] over
//            its part of the carrier it writes (zpart), and the group sums
//            of beta0 (w0part), both double-buffered by frame parity; the
//            next phase F adds z[g] to each member's u and
//            sum_g z[g] * (sum of the group's beta0) to the row dot.
// The host launches the instantiation of each scan that the graph needs
// (rows staged or read through L2, with or without the wildcard term), so
// a graph without a wildcard and with staged rows runs code that has
// neither.  Every numeric reduction runs in a fixed order with no atomics
// (the barrier's counter is the only atomic), so runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kTiny = 1e-30f;
constexpr float kObsFloor = 1e-30f;
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64;   // batch rows per tile
constexpr int BN = 160;  // output columns per tile
constexpr int BK = 32;   // depth per pipeline stage
constexpr int kStages = 4;
constexpr int MT = 2;  // m16 tiles per warp (32 rows)
constexpr int NT = 5;  // n8 tiles per warp (40 columns)
constexpr int A_LD = BK + 4;      // A stage [BM][A_LD]
constexpr int B_KN_LD = BN + 8;   // forward B stage [BK][B_KN_LD]
constexpr int B_NK_LD = BK + 4;   // adjoint B stage [BN][B_NK_LD]
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE =
    BK * B_KN_LD > BN * B_NK_LD ? BK * B_KN_LD : BN * B_NK_LD;
constexpr int kRingBytes = kStages * (A_STAGE + B_STAGE) * 4;  // 129,024
constexpr int kSmemBytes = 200 * 1024;  // ring, or rows of the row passes
constexpr int kUnroll = 8;   // loads in flight per thread in the row passes
constexpr int kPad = 64;     // scratch sections start on 256-byte bounds
constexpr int kMaxR = 4;     // wildcard groups the kernels take
constexpr int kMaxH = 16;    // row parts of the row passes, at most
constexpr int kSmemFloats = kSmemBytes / 4;

static_assert(MT * 16 * 2 == BM && NT * 8 * 4 == BN, "warp tiling");
static_assert(kRingBytes <= kSmemBytes, "the ring fits");

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

// ------------------------------------------------------------ primitives

// Division of 0 <= n < 2^31 by a runtime constant d >= 1 as a multiply and
// a shift; the magic numbers are made once on the host.
struct FastDiv {
  unsigned d, m, s;
  FastDiv() = default;
  explicit FastDiv(unsigned div) : d(div), s(0) {
    while ((1u << s) < div) ++s;
    m = (unsigned)(((1ull << 32) * ((1ull << s) - div)) / div + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, m) + (unsigned)n) >> s);
  }
  __device__ __forceinline__ int mod(int n) const {
    return n - div(n) * (int)d;
  }
};

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
// rounds, but in two integer operations at the full ALU rate), lo = x - hi
// exactly, handed to the tensor cores as it is: they read its top 19 bits,
// i.e. truncate it to TF32.
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

// 16-byte copy global -> shared; zero-fills when !valid (src is then not
// read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid = true) {
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sum over the warp, the same bits in every lane (each butterfly stage
// adds the same two values in either lane).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Fixed-order sum of n values, identical in every warp that calls it.
// Reads through L2 (__ldcg): the values were written by other blocks
// earlier in the same launch.
__device__ __forceinline__ float warp_sum_of(const float* p, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i0 = lane; i0 < n; i0 += 32 * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x[u] = i0 + 32 * u < n ? __ldcg(p + i0 + 32 * u) : 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += x[u];
  }
  return warp_sum(s);
}

// Sum over the block of one value per thread, in one fixed order (the same
// bits in every block that sums the same values); every thread gets it.
// red holds kWarps floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Row passes: row b of B is cut into H parts, H as large as keeps the
// B*H items within one per block, and at most kMaxH.  What a part computes
// per element does not depend on H.
__device__ __forceinline__ int row_parts(int B) {
  return max(1, min(kMaxH, (int)gridDim.x / B));
}

// A row element: from shared memory, or (kL2) through L2 from global memory
// written earlier in this launch.
template <bool kL2>
__device__ __forceinline__ float row_at(const float* row, int i) {
  if (kL2) return __ldcg(row + i);
  return row[i];
}

// Adds x into acc[g] for the wildcard group g of its slot (gg < 0: none),
// with no dynamic register indexing.
__device__ __forceinline__ void add_to_group(float (&acc)[kMaxR], int gg,
                                             float x) {
#pragma unroll
  for (int g = 0; g < kMaxR; ++g)
    if (gg == g) acc[g] += x;
}

__device__ __forceinline__ int part_begin(int n, int h, int H) {
  return (int)((long long)n * h / H);
}

// Starts asynchronous copies of src[0..n) into shared memory at base
// (16-byte aligned, room for n + 3 floats), 16 bytes a copy where source
// and destination agree modulo 16 bytes, and returns where the row starts
// in shared memory.  All of a block's copies are in flight at once; the
// caller commits, waits and syncs.
__device__ float* stage_async(float* base, const float* src, int n) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* dst = base + mis;
  const int head = min(n, (4 - mis) & 3);
  const int end = head + (n - head) / 4 * 4;
  for (int i = threadIdx.x; i < head; i += kThreads)
    cp_async4(dst + i, src + i);
  for (int i = head + 4 * threadIdx.x; i < end; i += 4 * kThreads)
    cp_async16(dst + i, src + i);
  for (int i = end + threadIdx.x; i < n; i += kThreads)
    cp_async4(dst + i, src + i);
  return dst;
}

// The forward's gather from a row staged in shared memory (or, kL2, read
// in place through L2), for source slots j in [j0, j1): store(j, sum_r
// row[enter(perm[j], r)] + row[loop j], add[j]) with add[j] read only when
// add is not null.  Each thread's global loads are issued together, before
// any use (a warp issues in order, and a use of a pending load stalls it).
template <bool kL2, typename F>
__device__ void gather_row(const int* __restrict__ perm,
                           const float* __restrict__ add, const float* row,
                           int C, int NSRC, int NDP, int R, FastDiv fnsrc,
                           FastDiv fndpos, int j0, int j1, F store) {
  const int NDPOS = (NDP - NSRC) / R;
  for (int i0 = j0 + threadIdx.x; i0 < j1; i0 += kThreads * kUnroll) {
    int k[kUnroll];
    float ad[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = min(i0 + u * kThreads, j1 - 1);
      k[u] = __ldg(perm + j);
      ad[u] = add ? __ldg(add + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i0 + u * kThreads;
      if (j >= j1) continue;
      const int c = fnsrc.div(j), s = j - c * NSRC;
      float x = row_at<kL2>(row, c * NDP + R * NDPOS + s);  // loop slot
      if (k[u] < C * NDPOS) {
        const int kc = fndpos.div(k[u]);
        const float* e = row + kc * NDP + (k[u] - kc * NDPOS);
        float acc = row_at<kL2>(e, 0);
        for (int r = 1; r < R; ++r) acc += row_at<kL2>(e, r * NDPOS);
        x = acc + x;
      }
      store(j, x, ad[u]);
    }
  }
}

// ------------------------------------------------------ the block product

// One BM x BN tile of A @ B over k in [k_begin, k_end) on the tensor cores
// (3xTF32), into acc.  A rows come from a padded buffer (row stride lda,
// 16-byte aligned, zeros past the valid depth); k_begin and k_end are
// multiples of BK.  B element (k, n) is b[k * ldb + n] (kNK false,
// forward: W_c rows) or b[n * ldb + k] (kNK true, adjoint: W_c read along
// d), zero for n >= n_valid or k >= k_valid; ldb is a multiple of 4 and
// the row ends are zero up to it, so B moves in 16-byte copies too.
template <bool kNK>
__device__ void tile_product(const float* __restrict__ a, int lda,
                             const float* __restrict__ b, int ldb,
                             int n_valid, int k_valid, int k_begin,
                             int k_end, float* smem,
                             float (&acc)[MT][NT][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t4 = lane & 3;
  float* As = smem;
  float* Bs = smem + kStages * A_STAGE;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto load = [&](int slot, int k0) {
    float* as = As + slot * A_STAGE;
    float* bs = Bs + slot * B_STAGE;
#pragma unroll
    for (int i = 0; i < (BM * BK / 4) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      const int r = v / (BK / 4), c4 = (v % (BK / 4)) * 4;
      cp_async16(as + r * A_LD + c4, a + (size_t)r * lda + k0 + c4);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 4) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (kNK) {
        const int n = e / (BK / 4), k4 = (e % (BK / 4)) * 4;
        const bool ok = n < n_valid && k0 + k4 < k_valid;
        cp_async16(bs + n * B_NK_LD + k4,
                   ok ? b + (size_t)n * ldb + k0 + k4 : b, ok);
      } else {
        const int k = e / (BN / 4), n4 = (e % (BN / 4)) * 4;
        const bool ok = n4 < n_valid && k0 + k < k_valid;
        cp_async16(bs + k * B_KN_LD + n4,
                   ok ? b + (size_t)(k0 + k) * ldb + n4 : b, ok);
      }
    }
  };

  const int nk = (k_end - k_begin) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = kc + kStages - 1;
    if (nx < nk) load(nx % kStages, k_begin + nx * BK);
    cp_async_commit();
    const float* as = As + (kc % kStages) * A_STAGE;
    const float* bs = Bs + (kc % kStages) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ap = as + (wm * 32 + i * 16 + g) * A_LD + kk + t4;
        split_tf32(ap[0], ah[i][0], al[i][0]);
        split_tf32(ap[8 * A_LD], ah[i][1], al[i][1]);
        split_tf32(ap[4], ah[i][2], al[i][2]);
        split_tf32(ap[8 * A_LD + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * 40 + j * 8 + g;
        float b0, b1;
        if (kNK) {
          b0 = bs[n * B_NK_LD + kk + t4];
          b1 = bs[n * B_NK_LD + kk + t4 + 4];
        } else {
          b0 = bs[(kk + t4) * B_KN_LD + n];
          b1 = bs[(kk + t4 + 4) * B_KN_LD + n];
        }
        split_tf32(b0, bh[j][0], bl[j][0]);
        split_tf32(b1, bh[j][1], bl[j][1]);
      }
      // the three passes in turn over all (i, j), so that consecutive
      // mma.sync never wait on the same accumulator
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Calls f(i, j, q, r, n) for each accumulator element acc[i][j][q] of the
// calling thread, r and n its row and column in the tile.
template <typename F>
__device__ __forceinline__ void for_each_frag(F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(i, j, q, wm * 32 + i * 16 + (q >> 1) * 8 + g,
          wn * 40 + j * 8 + 2 * t4 + (q & 1));
}

// Stores the pair x0, x1 at dst[0], dst[1] where valid (n_left elements
// are left in the row), as one 8-byte store where the pair is aligned.
__device__ __forceinline__ void store_pair(float* dst, float x0, float x1,
                                           int n_left, bool aligned) {
  if (aligned && n_left >= 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else {
    if (n_left >= 1) dst[0] = x0;
    if (n_left >= 2) dst[1] = x1;
  }
}

// Row sums of a tile from per-thread sums over its fragment rows:
// rs[i][h] covers row wm*32 + i*16 + h*8 + g.  Returns, in thread r < BM,
// the sum of tile row r over the tile's columns (fixed order).
__device__ __forceinline__ float tile_row_sum(float (&rs)[MT][2],
                                              float (*red)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rs[i][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0)
        red[wm * 32 + i * 16 + h * 8 + (lane >> 2)][wn] = v;
    }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < BM) {
    const float* r = red[threadIdx.x];
    s = ((r[0] + r[1]) + r[2]) + r[3];
  }
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------- forward

template <typename ObsT>
struct FwdArgs {
  const ObsT* obs;         // [B, T, V]
  const float* w;          // [C, NSRC, LDW], zero past NDP
  const int* perm;         // [C*NSRC]
  const float* init_pos;   // [C*NSRC]
  const float* init_v;     // [V]
  const float* final_v;    // [V]
  const int* gid;          // [C*NSRC] wildcard group of a slot, -1 = none
  const float* bvec;       // [RW, V] the groups' shared out-rows
  float leaky;
  int B, T, C, NSRC, NDP, R, LDW, RW;  // RW: wildcard groups, 0 = none
  float* alphas;           // [T, B, V] normalized
  float* cs;               // [T, B]
  float* logz;             // [B]
  unsigned int* counter;   // barrier, zeroed
  float* beta;             // [C, Bp, KP], zero padding
  float* araw;             // [B, V] unnormalized alpha of the last frame
  float* partial;          // [B, P] row sums per tile
  float* partial_f;        // [B, P] row sums of araw * final_v per tile
  float* wpart;            // [B, kMaxH, RW] group sums of beta per part
  FastDiv fd_nsrc, fd_ndp, fd_ndpos;
};

template <typename ObsT>
__device__ __forceinline__ int fwd_partials(const FwdArgs<ObsT>& p) {
  return p.C * ((p.NDP + BN - 1) / BN);
}

// Phase P of frame t: the product tiles (frame 0: init_v * obs_0), plus
// the wildcard term, each writing its unnormalized tile and one partial row
// sum.
template <bool kWild, typename ObsT>
__device__ void fwd_products(const FwdArgs<ObsT>& p, int t, float* smem,
                             float (*red)[4], float (*wms)[kMaxR]) {
  const int V = p.C * p.NDP;
  const int ntd = (p.NDP + BN - 1) / BN;
  const int P = p.C * ntd;
  const int Bp = (p.B + BM - 1) / BM * BM;
  const int KP = (p.NSRC + BK - 1) / BK * BK;
  const int ntiles = (Bp / BM) * P;
  const bool last = t == p.T - 1;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int mt = tile / P, pc = tile % P;
    const int c = pc / ntd, n0 = (pc % ntd) * BN;
    float acc[MT][NT][4];
    if (t > 0) {
      tile_product<false>(p.beta + ((size_t)c * Bp + mt * BM) * KP, KP,
                          p.w + (size_t)c * p.NSRC * p.LDW + n0, p.LDW,
                          min(BN, p.NDP - n0), p.NSRC, 0, KP, smem, acc);
    }
    // every load of the epilogue is issued before its first store
    float ob[MT][NT][4];
    for_each_frag([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, d = n0 + n;
      const bool ok = row < p.B && d < p.NDP;
      const size_t col = (size_t)c * p.NDP + d;
      ob[i][j][q] =
          ok ? load_obs(p.obs, ((size_t)row * p.T + t) * V + col) : 0.f;
      if (t == 0) acc[i][j][q] = ok ? __ldg(p.init_v + col) : 0.f;
    });
    if (kWild && t > 0) {
      // the tile rows' group sums of beta: the row parts' sums in order
      const int H = row_parts(p.B);
      if (threadIdx.x < BM) {
        const int row = mt * BM + threadIdx.x;
#pragma unroll
        for (int g = 0; g < kMaxR; ++g) {
          float w = 0.f;
          if (g < p.RW && row < p.B)
            for (int h = 0; h < H; ++h)
              w += __ldcg(p.wpart + ((size_t)row * kMaxH + h) * p.RW + g);
          wms[threadIdx.x][g] = w;
        }
      }
      __syncthreads();
      for_each_frag([&](int i, int j, int q, int r, int n) {
        const int d = n0 + n;
        if (d < p.NDP)
          for (int g = 0; g < p.RW; ++g)
            acc[i][j][q] += wms[r][g] *
                            __ldg(p.bvec + (size_t)g * V + c * p.NDP + d);
      });
    }
    float rs[MT][2] = {}, rf[MT][2] = {};
    const bool aligned = ((V | p.NDP) & 1) == 0;
    for_each_frag([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, d = n0 + n;
      acc[i][j][q] *= ob[i][j][q];
      if (row < p.B && d < p.NDP) rs[i][q >> 1] += acc[i][j][q];
      if ((q & 1) && row < p.B)  // columns d - 1, d
        store_pair(p.araw + (size_t)row * V + (size_t)c * p.NDP + d - 1,
                   acc[i][j][q - 1], acc[i][j][q], p.NDP - (d - 1), aligned);
    });
    if (last)
      for_each_frag([&](int i, int j, int q, int r, int n) {
        const int d = n0 + n;
        if (mt * BM + r < p.B && d < p.NDP)
          rf[i][q >> 1] +=
              acc[i][j][q] * __ldg(p.final_v + (size_t)c * p.NDP + d);
      });
    const float s = tile_row_sum(rs, red);
    float sf = 0.f;
    if (last) sf = tile_row_sum(rf, red);
    const int row = mt * BM + threadIdx.x;
    if (threadIdx.x < BM && row < p.B) {
      p.partial[(size_t)row * P + pc] = s;
      if (last) p.partial_f[(size_t)row * P + pc] = sf;
    }
  }
}

// Phase G of frame t (t < T-1), per row part: c_t (every warp reduces the
// row's partials in the same order, so all blocks hold the same bits),
// alphas[t] = araw / c_t, cs[t], and beta of frame t+1 gathered from the
// row staged in shared memory (kL2: read in place), 1/c_t folded in; with
// a wildcard term, the part's group sums of beta.
template <bool kL2, bool kWild, typename ObsT>
__device__ void fwd_gather(const FwdArgs<ObsT>& p, int t, float* smem,
                           float* red) {
  const int V = p.C * p.NDP;
  const int CS = p.C * p.NSRC;
  const int Bp = (p.B + BM - 1) / BM * BM;
  const int KP = (p.NSRC + BK - 1) / BK * BK;
  const int P = fwd_partials(p);
  const int H = row_parts(p.B);
  for (int item = blockIdx.x; item < p.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const float* row = p.araw + (size_t)b * V;
    if (!kL2) {
      row = stage_async(smem, row, V);
      cp_async_commit();
    }
    const float c = fmaxf(warp_sum_of(p.partial + (size_t)b * P, P), kTiny);
    const float rc = 1.f / c;
    if (!kL2) {
      cp_async_wait<0>();
      __syncthreads();
    }
    float* out = p.alphas + ((size_t)t * p.B + b) * V;
    const int v1 = part_begin(V, h + 1, H);
    for (int v = part_begin(V, h, H) + threadIdx.x; v < v1; v += kThreads)
      out[v] = row_at<kL2>(row, v) * rc;
    float wacc[kMaxR] = {};
    gather_row<kL2>(p.perm, p.leaky > 0.f ? p.init_pos : nullptr, row, p.C,
                    p.NSRC, p.NDP, p.R, p.fd_nsrc, p.fd_ndpos,
                    part_begin(CS, h, H), part_begin(CS, h + 1, H),
                    [&](int j, float x, float ip) {
                      x = x * rc;
                      if (p.leaky > 0.f) x += p.leaky * ip;
                      const int cc = p.fd_nsrc.div(j);
                      p.beta[((size_t)cc * Bp + b) * KP + (j - cc * p.NSRC)] =
                          x;
                      if (kWild) add_to_group(wacc, __ldg(p.gid + j), x);
                    });
    for (int g = 0; kWild && g < p.RW; ++g) {
      const float w = block_sum(wacc[g], red);
      if (threadIdx.x == 0)
        p.wpart[((size_t)b * kMaxH + h) * p.RW + g] = w;
    }
    if (h == 0 && threadIdx.x == 0) p.cs[(size_t)t * p.B + b] = c;
    __syncthreads();
  }
}

// After the last frame's products, per row part: alphas[T-1], cs[T-1], and
// in part 0 logz = sum_t log c_t + log max(sum alpha_last * final_v, 1e-30).
template <typename ObsT>
__device__ void fwd_finish(const FwdArgs<ObsT>& p) {
  const int V = p.C * p.NDP;
  const int P = fwd_partials(p);
  const int t = p.T - 1;
  const int H = row_parts(p.B);
  const int lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < p.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const float c = fmaxf(warp_sum_of(p.partial + (size_t)b * P, P), kTiny);
    const float rc = 1.f / c;
    const float* in = p.araw + (size_t)b * V;
    float* out = p.alphas + ((size_t)t * p.B + b) * V;
    const int v1 = part_begin(V, h + 1, H);
    for (int v0 = part_begin(V, h, H) + threadIdx.x; v0 < v1;
         v0 += kThreads * kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads;
        x[u] = v < v1 ? __ldcg(in + v) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads;
        if (v < v1) out[v] = x[u] * rc;
      }
    }
    if (h == 0 && threadIdx.x < 32) {
      const float zf =
          warp_sum_of(p.partial_f + (size_t)b * P, P) / c;
      float z = 0.f;
      for (int u = lane; u < t; u += 32)
        z += logf(__ldcg(p.cs + (size_t)u * p.B + b));
      z = warp_sum(z);
      if (lane == 0) {
        p.cs[(size_t)t * p.B + b] = c;
        p.logz[b] = (z + logf(c)) + logf(fmaxf(zf, kTiny));
      }
    }
  }
}

// kL2: rows that do not fit shared memory, gathered in place through L2;
// kWild: a wildcard term.  The host picks the instantiation, so a graph
// without either runs code that has neither.
template <bool kL2, bool kWild, typename ObsT>
__global__ void __launch_bounds__(kThreads, 1) fwd_scan(FwdArgs<ObsT> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[BM][4];
  __shared__ float wms[BM][kMaxR];
  fwd_products<kWild>(p, 0, smem, red, wms);
  for (int t = 1; t < p.T; ++t) {
    grid_sync(p.counter);
    fwd_gather<kL2, kWild>(p, t - 1, smem, &red[0][0]);
    grid_sync(p.counter);
    fwd_products<kWild>(p, t, smem, red, wms);
  }
  grid_sync(p.counter);
  fwd_finish(p);
}

// --------------------------------------------------------------- backward

template <typename ObsT>
struct BwdArgs {
  const ObsT* obs;         // [B, T, V]
  const float* w;          // [C, NSRC, LDW], zero past NDP
  const int* perm;         // [C*NSRC]
  const int* perm_inv;     // [C*NDPOS]
  const float* final_v;    // [V]
  const float* alphas;     // [T, B, V]
  const float* cs;         // [T, B]
  const float* gbar;       // [B]
  const int* gid;          // [C*NSRC] wildcard group of a slot, -1 = none
  const float* bvec;       // [RW, V] the groups' shared out-rows
  int B, T, C, NSRC, NDP, R, LDW, S, RW;  // RW: wildcard groups, 0 = none
  ObsT* grad;              // [B, T, V]
  unsigned int* counter;   // barrier, zeroed
  float* vcar;             // [C, Bp, NDPP], zero padding
  float* upart;            // [S, B, C*NSRC]
  float* dpart;            // [B, C*NTS*S] partial dots
  float* beta0;            // [B, C*NSRC] gather of alpha_t, no leaky
  float* zpart;            // [2, B, kMaxH, RW] carrier . vec[g] per part
  float* w0part;           // [2, B, kMaxH, RW] group sums of beta0 per part
  FastDiv fd_nsrc, fd_ndp, fd_ndpos;
};

// Wildcard partial sums of frame t, buffer t & 1: row b, part h, group g.
template <typename ObsT>
__device__ __forceinline__ float* wild_at(const BwdArgs<ObsT>& p, float* base,
                                          int t, int b, int h) {
  return base + (((size_t)(t & 1) * p.B + b) * kMaxH + h) * p.RW;
}

// Block sums of acc[g], written by thread 0 to dst[g].
template <typename ObsT>
__device__ __forceinline__ void store_group_sums(const BwdArgs<ObsT>& p,
                                                 const float (&acc)[kMaxR],
                                                 float* dst, float* red) {
  for (int g = 0; g < p.RW; ++g) {
    const float w = block_sum(acc[g], red);
    if (threadIdx.x == 0) dst[g] = w;
  }
}

// Part [v0, v1) of row b of frame t: bar = g - dot + gbar, the obs
// gradient alpha*bar / max(obs, 1e-30) in obs's dtype and, for t > 0, the
// carrier (bar / c_t) * obs, adding carrier * vec[g] into zacc[g] on a
// wildcard graph.  kLast: g = gbar * final_v / zfin (rzfin = 1 / zfin);
// else g is
// u (staged in shared memory as us) through perm_inv, broadcast to the R
// enter slots, and the loop slice.  Global loads first (clamped indices, no
// branches), then the shared-memory reads that depend on them, then the
// stores.
template <bool kLast, bool kWild, typename ObsT>
__device__ __forceinline__ void bwd_emit(const BwdArgs<ObsT>& p, int t,
                                         int b, int v0, int v1, float dot,
                                         const float* us, float rzfin,
                                         float (&zacc)[kMaxR]) {
  const int V = p.C * p.NDP;
  const int CS = p.C * p.NSRC;
  const int NDPOS = (p.NDP - p.NSRC) / p.R;
  const int Bp = (p.B + BM - 1) / BM * BM;
  const int NDPP = (p.NDP + BK - 1) / BK * BK;
  const float gb = __ldg(p.gbar + b);
  const float rct = 1.f / __ldg(p.cs + (size_t)t * p.B + b);
  const float* al = p.alphas + ((size_t)t * p.B + b) * V;
  const size_t orow = ((size_t)b * p.T + t) * V;
  for (int i0 = v0 + threadIdx.x; i0 < v1; i0 += kThreads * kUnroll) {
    float gg[kUnroll], a[kUnroll], o[kUnroll];
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = min(i0 + u * kThreads, v1 - 1);
      a[u] = __ldg(al + v);
      o[u] = load_obs(p.obs, orow + v);
      if (kLast) {
        gg[u] = __ldg(p.final_v + v);
      } else {
        const int c = p.fd_ndp.div(v), d = v - c * p.NDP;
        const int pi = __ldg(p.perm_inv + c * NDPOS + p.fd_ndpos.mod(d));
        j[u] = d < p.R * NDPOS ? pi : c * p.NSRC + (d - p.R * NDPOS);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      gg[u] = kLast ? gb * gg[u] * rzfin : (j[u] < CS ? us[j[u]] : 0.f);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = i0 + u * kThreads;
      if (v >= v1) continue;
      const float bar = gg[u] - dot + gb;
      store_grad(p.grad, orow + v,
                 __fdividef(a[u] * bar, fmaxf(o[u], kObsFloor)));
      if (t > 0) {
        const int c = p.fd_ndp.div(v);
        const float x = (bar * rct) * o[u];
        p.vcar[((size_t)c * Bp + b) * NDPP + (v - c * p.NDP)] = x;
        if (kWild) {
#pragma unroll
          for (int g = 0; g < kMaxR; ++g)
            if (g < p.RW) zacc[g] += x * __ldg(p.bvec + (size_t)g * V + v);
        }
      }
    }
  }
}

// beta0 of frame t (the forward's gather of alpha_t, no leaky term) for
// part h of row b, from alpha_t's row staged in shared memory (kL2: read in
// place); on a wildcard graph, the part's group sums of beta0 into w0part.
template <bool kL2, bool kWild, typename ObsT>
__device__ void bwd_beta0(const BwdArgs<ObsT>& p, int t, int b, int h, int H,
                          const float* arow, float* red) {
  const int CS = p.C * p.NSRC;
  float wacc[kMaxR] = {};
  gather_row<kL2>(p.perm, nullptr, arow, p.C, p.NSRC, p.NDP, p.R, p.fd_nsrc,
                  p.fd_ndpos, part_begin(CS, h, H), part_begin(CS, h + 1, H),
                  [&](int j, float x, float) {
                    p.beta0[(size_t)b * CS + j] = x;
                    if (kWild) add_to_group(wacc, __ldg(p.gid + j), x);
                  });
  if (kWild) store_group_sums(p, wacc, wild_at(p, p.w0part, t, b, h), red);
}

// Frame T-1, per row part: S = sum(alpha_last * final_v) over the whole
// row (a block sum, the same bits in every block), zfin = max(S, 1e-30),
// g = gbar * final_v / zfin, dot = gbar * S / zfin; then beta0 of T-2.
template <bool kL2, bool kWild, typename ObsT>
__device__ void bwd_last(const BwdArgs<ObsT>& p, float* smem, float* red) {
  const int V = p.C * p.NDP;
  const int H = row_parts(p.B);
  for (int item = blockIdx.x; item < p.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const float* al = p.alphas + ((size_t)(p.T - 1) * p.B + b) * V;
    float s = 0.f;
    for (int v0 = threadIdx.x; v0 < V; v0 += kThreads * kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads;
        x[u] = v < V ? __ldg(al + v) * __ldg(p.final_v + v) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s += x[u];
    }
    const float S = block_sum(s, red);
    const float zfin = fmaxf(S, kTiny);
    const float gb = __ldg(p.gbar + b);
    const float* arow =
        p.T > 1 ? p.alphas + ((size_t)(p.T - 2) * p.B + b) * V : nullptr;
    if (!kL2 && p.T > 1) {
      arow = stage_async(smem, arow, V);
      cp_async_commit();
    }
    float zacc[kMaxR] = {};
    bwd_emit<true, kWild>(p, p.T - 1, b, part_begin(V, h, H),
                          part_begin(V, h + 1, H), gb * (S / zfin), nullptr,
                          1.f / zfin, zacc);
    if (kWild && p.T > 1)
      store_group_sums(p, zacc, wild_at(p, p.zpart, p.T - 1, b, h), red);
    cp_async_wait<0>();
    __syncthreads();
    if (p.T > 1) bwd_beta0<kL2, kWild>(p, p.T - 2, b, h, H, arow, red);
    __syncthreads();
  }
}

// Phase P of frame t: u = v_{t+1} @ W^T partials and the partial dots
// sum_j u[j] * beta0_t[j].
template <typename ObsT>
__device__ void bwd_products(const BwdArgs<ObsT>& p, float* smem,
                             float (*red)[4]) {
  const int CS = p.C * p.NSRC;
  const int nts = (p.NSRC + BN - 1) / BN;
  const int Bp = (p.B + BM - 1) / BM * BM;
  const int NDPP = (p.NDP + BK - 1) / BK * BK;
  const int kchunks = NDPP / BK;
  const int per_split = (kchunks + p.S - 1) / p.S;
  const int Pd = p.C * nts * p.S;
  const int ntiles = (Bp / BM) * Pd;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int mt = tile / Pd, pd = tile % Pd;
    const int split = pd % p.S, cn = pd / p.S;
    const int c = cn / nts, n0 = (cn % nts) * BN;
    const int k_begin = min(kchunks, split * per_split) * BK;
    const int k_end = min(kchunks, (split + 1) * per_split) * BK;
    float acc[MT][NT][4];
    tile_product<true>(p.vcar + ((size_t)c * Bp + mt * BM) * NDPP, NDPP,
                       p.w + ((size_t)c * p.NSRC + n0) * p.LDW, p.LDW,
                       min(BN, p.NSRC - n0), p.NDP, k_begin, k_end, smem,
                       acc);
    // every load of the epilogue is issued before its first store
    float bz[MT][NT][4];
    for_each_frag([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, s = n0 + n;
      bz[i][j][q] = row < p.B && s < p.NSRC
                        ? __ldcg(p.beta0 + (size_t)row * CS +
                                 (size_t)c * p.NSRC + s)
                        : 0.f;
    });
    float rs[MT][2] = {};
    const bool aligned = ((CS | p.NSRC) & 1) == 0;
    for_each_frag([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, s = n0 + n;
      if (row < p.B && s < p.NSRC) rs[i][q >> 1] += acc[i][j][q] * bz[i][j][q];
      if ((q & 1) && row < p.B)  // sources s - 1, s
        store_pair(p.upart + ((size_t)split * p.B + row) * CS +
                       (size_t)c * p.NSRC + s - 1,
                   acc[i][j][q - 1], acc[i][j][q], p.NSRC - (s - 1),
                   aligned);
    });
    const float s = tile_row_sum(rs, red);
    const int row = mt * BM + threadIdx.x;
    if (threadIdx.x < BM && row < p.B) p.dpart[(size_t)row * Pd + pd] = s;
  }
}

// Phase F of frame t, per row part: the row's dot (every warp reduces the
// partials in the same order), u = the sum of the S partials in order,
// staged in shared memory with alpha_{t-1}'s row (kL2: that row is read in
// place); on a wildcard graph z[g] = v_{t+1} . vec[g] and the group sums
// of beta0_t from the previous phase F's parts, z[g] added to each member's
// u and sum_g z[g] * (group sum) to the dot; g_t through perm_inv
// (sentinel C*NSRC reads zero), broadcast to the R enter slots, and the
// loop slice; the outputs of frame t; beta0 of frame t-1.
template <bool kL2, bool kWild, typename ObsT>
__device__ void bwd_frame(const BwdArgs<ObsT>& p, int t, float* smem,
                          float* red) {
  const int V = p.C * p.NDP;
  const int CS = p.C * p.NSRC;
  const int NDPOS = (p.NDP - p.NSRC) / p.R;
  const int Pd = p.C * ((p.NSRC + BN - 1) / BN) * p.S;
  const int H = row_parts(p.B);
  float* us = smem;
  for (int item = blockIdx.x; item < p.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const float* arow =
        t > 0 ? p.alphas + ((size_t)(t - 1) * p.B + b) * V : nullptr;
    if (!kL2 && t > 0) {
      arow = stage_async(smem + (CS + 3) / 4 * 4, arow, V);
      cp_async_commit();
    }
    float dot = warp_sum_of(p.dpart + (size_t)b * Pd, Pd);
    float z[kMaxR] = {};
    if (kWild) {
      float wsum[kMaxR] = {};
#pragma unroll
      for (int g = 0; g < kMaxR; ++g) {
        if (g >= p.RW) continue;
        for (int hh = 0; hh < H; ++hh) {
          z[g] += __ldcg(wild_at(p, p.zpart, t + 1, b, hh) + g);
          wsum[g] += __ldcg(wild_at(p, p.w0part, t, b, hh) + g);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxR; ++g) dot += z[g] * wsum[g];
    }
    for (int j0 = threadIdx.x; j0 < CS; j0 += kThreads * kUnroll) {
      float x[kUnroll] = {};
      for (int sp = 0; sp < p.S; ++sp) {
        const float* up = p.upart + ((size_t)sp * p.B + b) * CS;
        float y[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          y[u] = __ldcg(up + min(j0 + u * kThreads, CS - 1));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x[u] += y[u];
      }
      if (kWild) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gg = __ldg(p.gid + min(j0 + u * kThreads, CS - 1));
#pragma unroll
          for (int g = 0; g < kMaxR; ++g)
            if (gg == g) x[u] += z[g];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        if (j < CS) us[j] = x[u];
      }
    }
    if (!kL2) cp_async_wait<0>();
    __syncthreads();
    float zacc[kMaxR] = {};
    bwd_emit<false, kWild>(p, t, b, part_begin(V, h, H),
                           part_begin(V, h + 1, H), dot, us, 0.f, zacc);
    if (kWild && t > 0)
      store_group_sums(p, zacc, wild_at(p, p.zpart, t, b, h), red);
    if (t > 0) bwd_beta0<kL2, kWild>(p, t - 1, b, h, H, arow, red);
    __syncthreads();
  }
}

// kL2: alpha rows that do not fit beside u in shared memory, read in place;
// kWild: a wildcard term.  The host picks the instantiation.
template <bool kL2, bool kWild, typename ObsT>
__global__ void __launch_bounds__(kThreads, 1) bwd_scan(BwdArgs<ObsT> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[BM][4];
  bwd_last<kL2, kWild>(p, smem, &red[0][0]);
  for (int t = p.T - 2; t >= 0; --t) {
    grid_sync(p.counter);
    bwd_products(p, smem, red);
    grid_sync(p.counter);
    bwd_frame<kL2, kWild>(p, t, smem, &red[0][0]);
  }
}

// ------------------------------------------------------------------ host

size_t pad_up(size_t n) { return (n + kPad - 1) / kPad * kPad; }

// Blocks of a persistent launch of `kernel`: every block resident.
template <typename K>
cudaError_t persistent_grid(K kernel, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, kSmemBytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  return cudaSuccess;
}

// Shapes the kernels take: enter slots, 32-bit element counts, the
// adjoint's u row fits the shared memory of the row passes, W rows padded
// to a multiple of 4 floats, at most kMaxR wildcard groups.
bool shape_ok(int B, int C, int NSRC, int NDP, int LDW, int RW) {
  const long long V = (long long)C * NDP;
  return B >= 1 && NDP > NSRC && B * V < (1LL << 31) &&
         (long long)C * NSRC + 8 <= kSmemFloats && LDW % 4 == 0 &&
         LDW >= NDP && RW >= 0 && RW <= kMaxR;
}

struct FwdLayout {
  size_t counter, beta, araw, partial, partial_f, wpart, total;
};

FwdLayout fwd_layout(int B, int C, int NSRC, int NDP, int RW) {
  const size_t Bp = (B + BM - 1) / BM * BM;
  const size_t KP = (NSRC + BK - 1) / BK * BK;
  const size_t P = (size_t)C * ((NDP + BN - 1) / BN);
  FwdLayout l;
  l.counter = 0;
  l.beta = kPad;
  l.araw = l.beta + pad_up(C * Bp * KP);
  l.partial = l.araw + pad_up((size_t)B * C * NDP);
  l.partial_f = l.partial + pad_up(B * P);
  l.wpart = l.partial_f + pad_up(B * P);
  l.total = l.wpart + pad_up((size_t)B * kMaxH * RW);
  return l;
}

template <typename ObsT>
cudaError_t fwd_impl(FwdArgs<ObsT> p, float* scratch, cudaStream_t st) {
  if (!shape_ok(p.B, p.C, p.NSRC, p.NDP, p.LDW, p.RW))
    return cudaErrorInvalidValue;
  const FwdLayout l = fwd_layout(p.B, p.C, p.NSRC, p.NDP, p.RW);
  p.counter = reinterpret_cast<unsigned int*>(scratch + l.counter);
  p.beta = scratch + l.beta;
  p.araw = scratch + l.araw;
  p.partial = scratch + l.partial;
  p.partial_f = scratch + l.partial_f;
  p.wpart = scratch + l.wpart;
  p.fd_nsrc = FastDiv(p.NSRC);
  p.fd_ndp = FastDiv(p.NDP);
  p.fd_ndpos = FastDiv((p.NDP - p.NSRC) / p.R);
  // the counter and beta's zero padding
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, l.araw * sizeof(float), st);
  if (err != cudaSuccess) return err;
  const bool l2 = (long long)p.C * p.NDP + 4 > kSmemFloats;
  auto kernel = l2 ? (p.RW ? fwd_scan<true, true, ObsT>
                           : fwd_scan<true, false, ObsT>)
                   : (p.RW ? fwd_scan<false, true, ObsT>
                           : fwd_scan<false, false, ObsT>);
  int grid = 0;
  if ((err = persistent_grid(kernel, &grid)) != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, kThreads,
                                     args, kSmemBytes, st);
}

struct BwdLayout {
  size_t counter, vcar, upart, dpart, beta0, zpart, w0part, total;
};

BwdLayout bwd_layout(int B, int C, int NSRC, int NDP, int S, int RW) {
  const size_t Bp = (B + BM - 1) / BM * BM;
  const size_t NDPP = (NDP + BK - 1) / BK * BK;
  const size_t CS = (size_t)C * NSRC;
  const size_t Pd = (size_t)C * ((NSRC + BN - 1) / BN) * S;
  BwdLayout l;
  l.counter = 0;
  l.vcar = kPad;
  l.upart = l.vcar + pad_up(C * Bp * NDPP);
  l.dpart = l.upart + pad_up(S * B * CS);
  l.beta0 = l.dpart + pad_up(B * Pd);
  l.zpart = l.beta0 + pad_up(B * CS);
  l.w0part = l.zpart + pad_up((size_t)2 * B * kMaxH * RW);
  l.total = l.w0part + pad_up((size_t)2 * B * kMaxH * RW);
  return l;
}

// Splits of the adjoint's product over d: as many as fill the grid in one
// wave.  Where one split per tile already fills more than half the grid (the
// +-1 shape: 88 tiles on 132 SMs), the S <= 4 with the fewest waves per
// unit of depth, ceil(tiles * S / grid) / S (S = 3 there: two waves of a
// third of the depth each, against one wave of the whole depth on 88 SMs).
int bwd_splits_for(int grid, int B, int C, int NSRC, int NDP) {
  const int tiles = (B + BM - 1) / BM * C * ((NSRC + BN - 1) / BN);
  const int kchunks = (NDP + BK - 1) / BK;
  int s = grid / tiles;
  if (s < 2) {
    s = 1;
    for (int c = 2; c <= 4; ++c) {
      const long long waves_c = ((long long)tiles * c + grid - 1) / grid;
      const long long waves_s = ((long long)tiles * s + grid - 1) / grid;
      if (waves_c * s < waves_s * c) s = c;
    }
  }
  if (s > kchunks) s = kchunks;
  return s;
}

template <typename ObsT>
cudaError_t bwd_impl(BwdArgs<ObsT> p, float* scratch, cudaStream_t st) {
  if (!shape_ok(p.B, p.C, p.NSRC, p.NDP, p.LDW, p.RW))
    return cudaErrorInvalidValue;
  const BwdLayout l = bwd_layout(p.B, p.C, p.NSRC, p.NDP, p.S, p.RW);
  p.counter = reinterpret_cast<unsigned int*>(scratch + l.counter);
  p.vcar = scratch + l.vcar;
  p.upart = scratch + l.upart;
  p.dpart = scratch + l.dpart;
  p.beta0 = scratch + l.beta0;
  p.zpart = scratch + l.zpart;
  p.w0part = scratch + l.w0part;
  p.fd_nsrc = FastDiv(p.NSRC);
  p.fd_ndp = FastDiv(p.NDP);
  p.fd_ndpos = FastDiv((p.NDP - p.NSRC) / p.R);
  // the counter and the carrier's zero padding
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, l.upart * sizeof(float), st);
  if (err != cudaSuccess) return err;
  const long long cs4 = ((long long)p.C * p.NSRC + 3) / 4 * 4;
  const bool l2 = cs4 + (long long)p.C * p.NDP + 4 > kSmemFloats;
  auto kernel = l2 ? (p.RW ? bwd_scan<true, true, ObsT>
                           : bwd_scan<true, false, ObsT>)
                   : (p.RW ? bwd_scan<false, true, ObsT>
                           : bwd_scan<false, false, ObsT>);
  int grid = 0;
  if ((err = persistent_grid(kernel, &grid)) != cudaSuccess) return err;
  if (bwd_splits_for(grid, p.B, p.C, p.NSRC, p.NDP) != p.S)
    return cudaErrorInvalidValue;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, kThreads,
                                     args, kSmemBytes, st);
}

}  // namespace

extern "C" {

// Floats of scratch the forward needs with RW wildcard groups.
long long blocked_den_fwd_scratch(int B, int C, int NSRC, int NDP, int RW) {
  return (long long)fwd_layout(B, C, NSRC, NDP, RW).total;
}

// Wildcard groups the kernels take.
int blocked_den_max_groups() { return kMaxR; }

// d-splits of the adjoint's product on this device (0 on a CUDA error).
int blocked_den_bwd_splits(int B, int C, int NSRC, int NDP) {
  int grid = 0;
  if (persistent_grid(bwd_scan<false, false, float>, &grid) != cudaSuccess)
    return 0;
  return bwd_splits_for(grid, B, C, NSRC, NDP);
}

// Floats of scratch the adjoint needs with S splits, RW wildcard groups.
long long blocked_den_bwd_scratch(int B, int C, int NSRC, int NDP, int S,
                                  int RW) {
  return (long long)bwd_layout(B, C, NSRC, NDP, S, RW).total;
}

// Forward scan.  obs [B,T,V] (f32, or bf16 when obs_bf16); w [C,NSRC,LDW]
// with LDW a multiple of 4 >= NDP and zeros past NDP; RW wildcard groups
// (0: none, gid and bvec unused): gid [C*NSRC] each slot's group or -1,
// bvec [RW,V] the groups' out-rows.  Writes the normalized alphas [T,B,V],
// the scales cs [T,B] and logz [B].  scratch: blocked_den_fwd_scratch(...)
// floats.  One memset and one cooperative launch on `stream`; no host
// sync, no allocation.
int blocked_den_fwd(const void* obs, int obs_bf16, const float* w,
                    const int* perm, const float* init_pos,
                    const float* init_v, const float* final_v,
                    const int* gid, const float* bvec, float leaky, int B,
                    int T, int C, int NSRC, int NDP, int R, int LDW, int RW,
                    float* alphas, float* cs, float* logz, float* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (obs_bf16) {
    FwdArgs<__nv_bfloat16> p{static_cast<const __nv_bfloat16*>(obs), w, perm,
                             init_pos, init_v, final_v, gid, bvec, leaky, B,
                             T, C, NSRC, NDP, R, LDW, RW, alphas, cs, logz};
    return (int)fwd_impl(p, scratch, st);
  }
  FwdArgs<float> p{static_cast<const float*>(obs), w, perm, init_pos, init_v,
                   final_v, gid, bvec, leaky, B, T, C, NSRC, NDP, R, LDW, RW,
                   alphas, cs, logz};
  return (int)fwd_impl(p, scratch, st);
}

// Adjoint scan.  Writes grad [B,T,V] = d(sum_b gbar_b logz_b)/d obs in
// obs's dtype; w, RW, gid and bvec as for the forward.  S from
// blocked_den_bwd_splits; scratch: blocked_den_bwd_scratch(..., S, RW)
// floats.  One memset and one cooperative launch on `stream`; no host
// sync, no allocation.
int blocked_den_bwd(const void* obs, int obs_bf16, const float* w,
                    const int* perm, const int* perm_inv,
                    const float* final_v, const float* alphas,
                    const float* cs, const float* gbar, const int* gid,
                    const float* bvec, int B, int T, int C, int NSRC, int NDP,
                    int R, int LDW, int S, int RW, void* grad, float* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (obs_bf16) {
    BwdArgs<__nv_bfloat16> p{static_cast<const __nv_bfloat16*>(obs), w, perm,
                             perm_inv, final_v, alphas, cs, gbar, gid, bvec,
                             B, T, C, NSRC, NDP, R, LDW, S, RW,
                             static_cast<__nv_bfloat16*>(grad)};
    return (int)bwd_impl(p, scratch, st);
  }
  BwdArgs<float> p{static_cast<const float*>(obs), w, perm, perm_inv,
                   final_v, alphas, cs, gbar, gid, bvec, B, T, C, NSRC, NDP,
                   R, LDW, S, RW, static_cast<float*>(grad)};
  return (int)bwd_impl(p, scratch, st);
}

}  // extern "C"
