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
// sum per tile.  Where the tiles would leave half the grid idle (32 tiles
// at the planted-table den's B = 48), the product is split over its depth
// NSRC into SF = grid / tiles shares (kSplit): each tile writes its share
// as it is into a plane of its own (through shared memory, whole rows at a
// time), and phase G sums the planes in order, multiplies by obs and sums
// the row, so a split tile's epilogue is its stores.  Barrier.  Phase G (frame t -> t+1), per half row: the row
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
// At B <= 16 both directions take tiles of 16 rows (Tile<16>), their 8
// warps split 4 ways over the columns and 2 over each stage's depth, so no
// mma.sync multiplies padding rows (three quarters of a 64-row tile).
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
// 16-byte cp.async copies (129 KB) every frame; none of it stays in
// shared memory across frames, since a 64 x 160 tile needs 344 KB of W.
// At the flagship W is 40.5 MB and each frame finds it in the 50 MB L2.  At
// a committed +-1 graph's shape (C=22, NSRC=556, NDP=2796) it is 136.8 MB:
// it no longer fits L2, so each frame streams it from device memory (2.0
// ms over a 49-frame scan at 3.35 TB/s; below), which sets the 3xTF32
// bound there (the float32 rate's 3.2 ms does not change).  What holds it
// back at the flagship (tools/blocked_den_phases.py, per frame): the
// product's main loop, 27 us forward and 35 us adjoint, bound by the
// mma.sync rate of three TF32 passes (one pass saves 7 and 11 us) and by
// the W stream (no copies saves 4 and 10 us), which overlap only in part
// with one block of 8 warps a SM; the epilogue and barrier 7.5 us; the row
// passes 7 us forward and 16 us adjoint, plus a 1.5 us barrier each.
// wgmma (twice the mma.sync rate) fed by TMA, and keeping the next frame's
// W in flight across the barriers, are the next steps.
//
// A row that does not fit the row passes' shared memory (V > 51,196
// floats, beside u in the adjoint; the +-1 shape's 61,468 among them) is
// staged part by part (kPart): part h stages what its own gather reads,
// its slots' R enter slots and loop slot (stage_part), R+1 floats a slot,
// in the order of a gather plan built once per graph on the host (the
// part's slots sorted by perm, so that neighbouring lanes read
// neighbouring row elements), then gathers with the whole row's
// arithmetic and order (gather_part); its alphas are written from L2.  The
// row parts grow past grid / B only where a part would not fit.  Reading
// those rows element by element through L2 instead took 78 us of the
// +-1 forward's frame.  There the adjoint's phase F moves four consecutive
// elements a thread (bwd_emit4: 16-byte loads of alpha, obs and the
// out-rows, 16-byte stores of the gradient and the carrier) and sums u's
// splits in 16-byte loads: with 4-byte loads a block kept too few bytes in
// flight, and a row pass took 72-78 us.
//
// The plan (make_plan, on the host, from the graph's shape and the
// device alone): tile rows, depth splits, rows staged whole or by part,
// row parts, the adjoint's W copies evict_first or not; a shape without a
// plan is refused, naming why.  The host code runs each launch's plan
// itself; blocked_den_plan reports it.
//
// W past L2 (137 MB at the +-1 shape): no share of it is kept on chip
// across frames.  Kept with an evict_last policy (half of L2, the
// context's persisting set-aside raised to hold it) it cost the +-1
// forward 1.1 ms a scan and saved the adjoint 0.1: the frame's other
// traffic (obs, the unnormalized rows, alphas, u's partials, 40-60 MB a
// frame at B = 64) needs L2 too.  What pays is the adjoint copying W with an
// evict_first policy (cp.async's L2::cache_hint, w_first: rows staged by
// part and W past L2), so that W's stream, read once a frame, leaves L2
// before phase F's rows: 0.33-0.39 ms a scan at the +-1 and ctx shapes,
// as much as the kept share without the set-aside.  The forward takes no
// hint: with one it ran 0.7 ms slower (tools/blocked_den_phases.py).
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
// The host launches the instantiation of each scan that the plan names
// (tile rows, rows staged whole or by part, the forward split or not, with
// or without the wildcard term), so the flagship (64-row tiles, rows
// staged whole, no split, no wildcard) runs code that has none of the
// others.  Every numeric reduction runs in a fixed order with no atomics
// (the barrier's counter is the only atomic), so runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <mutex>

namespace {

constexpr float kTiny = 1e-30f;
constexpr float kObsFloor = 1e-30f;
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBMMax = 64;  // batch rows per tile, at most
constexpr int BN = 160;  // output columns per tile
constexpr int BK = 32;   // depth per pipeline stage
constexpr int kStages = 4;
constexpr int NT = 5;  // n8 tiles per warp (40 columns)
constexpr int A_LD = BK + 4;      // A stage [BM][A_LD]
constexpr int B_KN_LD = BN + 8;   // forward B stage [BK][B_KN_LD]
constexpr int B_NK_LD = BK + 4;   // adjoint B stage [BN][B_NK_LD]
constexpr int B_STAGE =
    BK * B_KN_LD > BN * B_NK_LD ? BK * B_KN_LD : BN * B_NK_LD;
constexpr int kSmemBytes = 200 * 1024;  // ring, or rows of the row passes
constexpr int kUnroll = 8;   // loads in flight per thread in the row passes
constexpr int kPad = 64;     // scratch sections start on 256-byte bounds
constexpr int kMaxR = 4;     // wildcard groups the kernels take
constexpr int kMaxH = 16;    // row parts of the row passes, at most
constexpr int kMaxS = 4;     // split partials loaded at once
constexpr int kSmemFloats = kSmemBytes / 4;

// A tile of the block product: kBM batch rows (64, or 16 at B <= 16) x BN
// columns on the 8 warps, WM of them along the rows, 4 along the columns
// and KG along the depth: at kBM = 16 each k8 step of a stage goes to one
// of two depth groups, whose sums are added in order after the main loop,
// so no mma.sync multiplies padding rows of a B <= 16 batch.
template <int kBM>
struct Tile {
  static constexpr int BM = kBM;
  static constexpr int WM = kBM >= 32 ? 2 : 1;  // warps along the rows
  static constexpr int KG = kWarps / (4 * WM);  // warps along the depth
  static constexpr int MT = kBM / (16 * WM);    // m16 tiles per warp
  static constexpr int A_STAGE = kBM * A_LD;
  static_assert(MT * 16 * WM == kBM && NT * 8 * 4 == BN &&
                    KG * WM * 4 == kWarps && kBM <= kBMMax,
                "warp tiling");
  static_assert(kStages * (A_STAGE + B_STAGE) * 4 <= kSmemBytes,
                "the ring fits");
  static_assert(KG == 1 || (KG - 1) * 4 * WM * 32 * MT * NT * 4 <=
                               kStages * (A_STAGE + B_STAGE),
                "the depth groups' sums fit the ring");
  __device__ static int wm() { return WM == 1 ? 0 : (threadIdx.x >> 5) % WM; }
  __device__ static int wn() { return ((threadIdx.x >> 5) / WM) % 4; }
  __device__ static int kg() {
    return KG == 1 ? 0 : (threadIdx.x >> 5) / (4 * WM);
  }
};

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
// Four consecutive elements from i (a multiple of 4; 16 or 8 bytes, one
// load or store), with the conversions of load_obs / store_grad.
__device__ __forceinline__ void load_obs4(const float* p, size_t i,
                                          float (&o)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
__device__ __forceinline__ void load_obs4(const __nv_bfloat16* p, size_t i,
                                          float (&o)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p + i));
  o[0] = __uint_as_float(x.x << 16), o[1] = __uint_as_float(x.x & 0xffff0000u);
  o[2] = __uint_as_float(x.y << 16), o[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void store_grad4(float* p, size_t i,
                                            const float (&x)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_grad4(__nv_bfloat16* p, size_t i,
                                            const float (&x)[4]) {
  unsigned h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __bfloat16_as_ushort(__float2bfloat16(x[k]));
  *reinterpret_cast<uint2*>(p + i) = make_uint2(h[0] | (h[1] << 16),
                                                h[2] | (h[3] << 16));
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

// The L2 policy evict_first, for copies of data that streams from device
// memory every frame and should leave L2 first.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// cp_async16 with an L2 eviction policy.
__device__ __forceinline__ void cp_async16_l2(float* dst, const float* src,
                                              bool valid, uint64_t pol) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      ::"r"(s), "l"(src), "r"(valid ? 16 : 0), "l"(pol));
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

// The forward's gather from a row staged whole in shared memory, for
// source slots j in [j0, j1): store(j, sum_r row[enter(perm[j], r)] +
// row[loop j], add[j], gid[j]) with add[j] and gid[j] read only when add
// and gid are not null (else 0 and -1).  Each
// thread's global loads are issued together, before any use (a warp issues
// in order, and a use of a pending load stalls it).
template <typename F>
__device__ void gather_row(const int* __restrict__ perm,
                           const float* __restrict__ add,
                           const int* __restrict__ gid, const float* row,
                           int C, int NSRC, int NDP, int R, FastDiv fnsrc,
                           FastDiv fndpos, int j0, int j1, F store) {
  const int NDPOS = (NDP - NSRC) / R;
  for (int i0 = j0 + threadIdx.x; i0 < j1; i0 += kThreads * kUnroll) {
    int k[kUnroll], gg[kUnroll];
    float ad[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = min(i0 + u * kThreads, j1 - 1);
      k[u] = __ldg(perm + j);
      ad[u] = add ? __ldg(add + j) : 0.f;
      gg[u] = gid ? __ldg(gid + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i0 + u * kThreads;
      if (j >= j1) continue;
      const int c = fnsrc.div(j), s = j - c * NSRC;
      float x = row[c * NDP + R * NDPOS + s];  // loop slot
      if (k[u] < C * NDPOS) {
        const int kc = fndpos.div(k[u]);
        const float* e = row + kc * NDP + (k[u] - kc * NDPOS);
        float acc = e[0];
        for (int r = 1; r < R; ++r) acc += e[r * NDPOS];
        x = acc + x;
      }
      store(j, x, ad[u], gg[u]);
    }
  }
}

// A row too long for shared memory: starts asynchronous copies of what
// the gather of source slots [j0, j1) reads from it (global memory written
// earlier in this launch, or by the forward launch), n = j1 - j0 slots,
// into s: enter slot r of slot j0 + i at s[r*n + i] (zero for the
// sentinel), its loop slot at s[R*n + i].  The loop slots are contiguous
// in the row; the enter slots are copied in the order of the part's gather
// plan (plan[q] = {i, perm[j0 + i]} for the part's slots sorted by
// perm[j0 + i], the sentinels last as {i, -1}; built once per graph and
// row parts on the host), so that neighbouring lanes read neighbouring
// elements of the row: a part of a +-1 row reads every sector of it once,
// not a sector per element.  The part's enter rows are disjoint from every
// other part's (perm is injective).  Each thread's plan loads are issued
// together before their copies.  The caller commits, waits and syncs.
__device__ void stage_part(float* s, const int2* __restrict__ plan,
                           const float* row, int NSRC, int NDP, int R,
                           FastDiv fnsrc, FastDiv fndpos, int j0, int j1) {
  const int NDPOS = (NDP - NSRC) / R;
  const int n = j1 - j0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = j0 + i, c = fnsrc.div(j);
    cp_async4(s + R * n + i, row + c * NDP + R * NDPOS + (j - c * NSRC));
  }
  for (int q0 = threadIdx.x; q0 < n; q0 += kThreads * kUnroll) {
    int2 e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      e[u] = __ldg(plan + j0 + min(q0 + u * kThreads, n - 1));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q0 + u * kThreads >= n) continue;
      const int i = e[u].x, k = e[u].y;
      if (k >= 0) {
        const int kc = fndpos.div(k);
        const float* src = row + kc * NDP + (k - kc * NDPOS);
        for (int r = 0; r < R; ++r) cp_async4(s + r * n + i, src + r * NDPOS);
      } else {
        for (int r = 0; r < R; ++r) s[r * n + i] = 0.f;
      }
    }
  }
}


// The gather of source slots [j0, j1) from a part staged by stage_part,
// with the arithmetic and order of gather_row (a sentinel slot adds its
// zero enter slots: (0 + ... + 0) + x = x).
template <typename F>
__device__ void gather_part(const float* s, const float* __restrict__ add,
                            const int* __restrict__ gid, int R, int j0,
                            int j1, F store) {
  const int n = j1 - j0;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
    int gg[kUnroll];
    float ad[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + min(i0 + u * kThreads, n - 1);
      ad[u] = add ? __ldg(add + j) : 0.f;
      gg[u] = gid ? __ldg(gid + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n) continue;
      float acc = s[i];
      for (int r = 1; r < R; ++r) acc += s[r * n + i];
      store(j0 + i, acc + s[R * n + i], ad[u], gg[u]);
    }
  }
}

// A row of a forward split over its depth, staged: dst[v] = (the sum of
// the S depth planes of src, stride floats apart, in plane order) * obs[v]
// for v < n; returns the row's sum, each thread's elements in order and
// then a block sum (every block that stages the row gets the same bits).
// Reads the planes through L2 (written by other blocks in this launch).
// red: kWarps floats of shared memory.
template <typename ObsT>
__device__ float stage_split_row(float* dst, const float* src,
                                 const ObsT* obs, int S, size_t stride,
                                 int n, float* red) {
  float sum = 0.f;
  for (int v0 = threadIdx.x; v0 < n; v0 += kThreads * kUnroll) {
    float x[kUnroll], o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = min(v0 + u * kThreads, n - 1);
      x[u] = __ldcg(src + v);
      o[u] = load_obs(obs, v);
    }
    // the loads of up to kMaxS planes at once, then the sums in order
    for (int s0 = 1; s0 < S; s0 += kMaxS) {
      float y[kMaxS][kUnroll];
#pragma unroll
      for (int sp = 0; sp < kMaxS; ++sp)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          y[sp][u] = s0 + sp < S ? __ldcg(src + (s0 + sp) * stride +
                                          min(v0 + u * kThreads, n - 1))
                                 : 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxS; ++sp)
        if (s0 + sp < S) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) x[u] += y[sp][u];
        }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < n) {
        const float a = x[u] * o[u];
        dst[v0 + u * kThreads] = a;
        sum += a;
      }
  }
  return block_sum(sum, red);
}

// ------------------------------------------------------ the block product

// One BM x BN tile of A @ B over k in [k_begin, k_end) on the tensor cores
// (3xTF32), into acc.  A rows come from a padded buffer (row stride lda,
// 16-byte aligned, zeros past the valid depth); k_begin and k_end are
// multiples of BK.  B element (k, n) is b[k * ldb + n] (kNK false,
// forward: W_c rows) or b[n * ldb + k] (kNK true, adjoint: W_c read along
// d), zero for n >= n_valid or k >= k_valid; ldb is a multiple of 4 and
// the row ends are zero up to it, so B moves in 16-byte copies too.
// kHint: B's copies take the L2 policy evict_first where `first` is set
// (a W past L2, in the adjoint).
template <bool kNK, typename TileT, bool kHint = false>
__device__ void tile_product(const float* __restrict__ a, int lda,
                             const float* __restrict__ b, int ldb,
                             int n_valid, int k_valid, int k_begin,
                             int k_end, float* smem,
                             float (&acc)[TileT::MT][NT][4],
                             bool first = false) {
  constexpr int BM = TileT::BM, MT = TileT::MT, KG = TileT::KG;
  constexpr int A_STAGE = TileT::A_STAGE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = TileT::wm(), wn = TileT::wn(), kg = TileT::kg();
  const int g = lane >> 2, t4 = lane & 3;
  float* As = smem;
  float* Bs = smem + kStages * A_STAGE;

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  const uint64_t pol = kHint ? l2_evict_first() : 0;
  auto copy_b = [&](float* dst, const float* src, bool ok) {
    if (kHint && first)
      cp_async16_l2(dst, src, ok, pol);
    else
      cp_async16(dst, src, ok);
  };

  auto load = [&](int slot, int k0) {
    float* as = As + slot * A_STAGE;
    float* bs = Bs + slot * B_STAGE;
    constexpr int kAVec = BM * BK / 4;
#pragma unroll
    for (int i = 0; i < (kAVec + kThreads - 1) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      if (kAVec % kThreads != 0 && v >= kAVec) break;
      const int r = v / (BK / 4), c4 = (v % (BK / 4)) * 4;
      cp_async16(as + r * A_LD + c4, a + (size_t)r * lda + k0 + c4);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 4) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (kNK) {
        const int n = e / (BK / 4), k4 = (e % (BK / 4)) * 4;
        const bool ok = n < n_valid && k0 + k4 < k_valid;
        copy_b(bs + n * B_NK_LD + k4,
               ok ? b + (size_t)n * ldb + k0 + k4 : b, ok);
      } else {
        const int k = e / (BN / 4), n4 = (e % (BN / 4)) * 4;
        const bool ok = n4 < n_valid && k0 + k < k_valid;
        copy_b(bs + k * B_KN_LD + n4,
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
    for (int q = 0; q < BK / (8 * KG); ++q) {
      const int kk = (q * KG + kg) * 8;  // this depth group's k8 steps
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ap = as + (wm * MT * 16 + i * 16 + g) * A_LD + kk + t4;
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
  if (KG > 1) {
    // the depth groups' sums, added into group 0's in group order through
    // the ring (free now), lane-minor so that no two lanes share a bank
    constexpr int kFrag = MT * NT * 4;
    const int slot = (tid >> 5) % (4 * TileT::WM);
    if (kg > 0) {
      float* dst = smem + (((kg - 1) * 4 * TileT::WM + slot) * kFrag) * 32;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dst[((i * NT + j) * 4 + q) * 32 + lane] = acc[i][j][q];
    }
    __syncthreads();
    if (kg == 0) {
      for (int gg = 1; gg < KG; ++gg) {
        const float* src =
            smem + (((gg - 1) * 4 * TileT::WM + slot) * kFrag) * 32;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[i][j][q] += src[((i * NT + j) * 4 + q) * 32 + lane];
      }
    }
    __syncthreads();
  }
}

// Calls f(i, j, q, r, n) for each accumulator element acc[i][j][q] of the
// calling thread, r and n its row and column in the tile (at KG > 1 only
// depth group 0 holds the tile after tile_product; the other warps call
// nothing).
template <typename TileT, typename F>
__device__ __forceinline__ void for_each_frag(F f) {
  if (TileT::KG > 1 && TileT::kg() != 0) return;
  const int lane = threadIdx.x & 31;
  const int wm = TileT::wm(), wn = TileT::wn(), g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < TileT::MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(i, j, q, wm * TileT::MT * 16 + i * 16 + (q >> 1) * 8 + g,
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
// rs[i][h] covers row wm*MT*16 + i*16 + h*8 + g.  Returns, in thread r <
// BM, the sum of tile row r over the tile's columns (fixed order).
template <typename TileT>
__device__ __forceinline__ float tile_row_sum(float (&rs)[TileT::MT][2],
                                              float (*red)[4]) {
  const int lane = threadIdx.x & 31;
  const int wm = TileT::wm(), wn = TileT::wn();
  if (TileT::KG == 1 || TileT::kg() == 0) {
#pragma unroll
    for (int i = 0; i < TileT::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = rs[i][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0)
          red[wm * TileT::MT * 16 + i * 16 + h * 8 + (lane >> 2)][wn] = v;
      }
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < TileT::BM) {
    const float* r = red[threadIdx.x];
    s = ((r[0] + r[1]) + r[2]) + r[3];
  }
  __syncthreads();
  return s;
}

// Writes a tile's accumulators, `rows` x `cols` of it, to dst (tile row r
// at dst + r * ld) through shared memory (the ring, free after the
// product), so that a warp writes 128 contiguous bytes of a row at a time:
// the fragments' own stores touch a sector for every 8 or 16 bytes.  At
// B = 48 with the forward split (NDP odd: one 4-byte store an element)
// this took its epilogue from 6.6 us a frame to 2.2; the unsplit tiles of
// the +-1 dens (8-byte pairs) gained nothing from it and the adjoint's lost
// 8-14 us, so they store their fragments.
template <typename TileT>
__device__ void store_tile(float* dst, size_t ld, int rows, int cols,
                           const float (&acc)[TileT::MT][NT][4],
                           float* smem) {
  constexpr int kLd = BN + 4;
  for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
    smem[r * kLd + n] = acc[i][j][q];
  });
  __syncthreads();
  for (int e = threadIdx.x; e < rows * BN; e += kThreads) {
    const int r = e / BN, n = e - r * BN;
    if (n < cols) dst[(size_t)r * ld + n] = smem[r * kLd + n];
  }
  __syncthreads();
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
  const int2* plan;        // [C*NSRC] gather plan of the row parts (kPart)
  float leaky;
  int B, T, C, NSRC, NDP, R, LDW, RW;  // RW: wildcard groups, 0 = none
  float* alphas;           // [T, B, V] normalized
  float* cs;               // [T, B]
  float* logz;             // [B]
  int Bp, SF, H;           // padded rows, depth splits, row parts (plan)
  unsigned int* counter;   // barrier, zeroed
  float* beta;             // [C, Bp, KP], zero padding
  float* araw;             // [SF, B, V] unnormalized alpha of the last
                           // frame, one partial product per depth split
  float* partial;          // [B, P] row sums per tile (unsplit)
  float* partial_f;        // [B, P] row sums of araw * final_v per tile
  float* wpart;            // [B, kMaxH, RW] group sums of beta per part
  FastDiv fd_nsrc, fd_ndp, fd_ndpos;
};

// Depth splits of the forward's product: p.SF in the split instantiation,
// else the constant 1 (the unsplit code has no split arithmetic at all).
template <bool kSplit, typename ObsT>
__device__ __forceinline__ int fwd_splits(const FwdArgs<ObsT>& p) {
  return kSplit ? p.SF : 1;
}

// Partial row sums per row: one per product tile of a row block (unsplit
// products; a split row is summed in the row pass).
template <typename ObsT>
__device__ __forceinline__ int fwd_partials(const FwdArgs<ObsT>& p) {
  return p.C * ((p.NDP + BN - 1) / BN);
}

// Phase P of frame t: the product tiles (frame 0: init_v * obs_0), plus
// the wildcard term, each writing its unnormalized tile and one partial row
// sum.  With SF > 1 depth splits (kSplit) each tile writes its share of the
// depth NSRC into araw's split plane as it is, with no obs and no row sum
// (split 0 adds the wildcard term and, at frame 0, is init_v): the row
// pass sums the planes, multiplies by obs and sums the row, so a split
// tile's epilogue is its stores alone.
template <typename TileT, bool kSplit, bool kWild, typename ObsT>
__device__ void fwd_products(const FwdArgs<ObsT>& p, int t, float* smem,
                             float (*red)[4], float (*wms)[kMaxR]) {
  constexpr int BM = TileT::BM, MT = TileT::MT;
  const int V = p.C * p.NDP;
  const int ntd = (p.NDP + BN - 1) / BN;
  const int P = p.C * ntd;
  const int SF = fwd_splits<kSplit>(p), PS = P * SF;
  const int KP = (p.NSRC + BK - 1) / BK * BK;
  const int kchunks = KP / BK;
  const int per_split = (kchunks + SF - 1) / SF;
  // rows padded to the tile, from B (p.Bp read here put 0.17 ms on the
  // flagship forward: its main loop then recomputed addresses)
  const int Bp = (p.B + BM - 1) / BM * BM;
  const int ntiles = (Bp / BM) * PS;
  const bool last = t == p.T - 1;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int mt = tile / PS, pcs = tile % PS;
    const int pc = pcs / SF, split = pcs % SF;
    const int c = pc / ntd, n0 = (pc % ntd) * BN;
    float acc[MT][NT][4];
    if (t > 0) {
      tile_product<false, TileT>(
          p.beta + ((size_t)c * Bp + mt * BM) * KP, KP,
          p.w + (size_t)c * p.NSRC * p.LDW + n0, p.LDW,
          min(BN, p.NDP - n0), p.NSRC,
          kSplit ? min(kchunks, split * per_split) * BK : 0,
          kSplit ? min(kchunks, (split + 1) * per_split) * BK : KP, smem, acc);
    }
    // every load of the epilogue is issued before its first store
    float ob[MT][NT][4];
    for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, d = n0 + n;
      const bool ok = row < p.B && d < p.NDP;
      const size_t col = (size_t)c * p.NDP + d;
      if (!kSplit)
        ob[i][j][q] =
            ok ? load_obs(p.obs, ((size_t)row * p.T + t) * V + col) : 0.f;
      if (t == 0) acc[i][j][q] = ok && split == 0 ? __ldg(p.init_v + col) : 0.f;
    });
    if (kWild && t > 0 && split == 0) {
      // the tile rows' group sums of beta: the row parts' sums in order
      if (threadIdx.x < BM) {
        const int row = mt * BM + threadIdx.x;
#pragma unroll
        for (int g = 0; g < kMaxR; ++g) {
          float w = 0.f;
          if (g < p.RW && row < p.B)
            for (int h = 0; h < p.H; ++h)
              w += __ldcg(p.wpart + ((size_t)row * kMaxH + h) * p.RW + g);
          wms[threadIdx.x][g] = w;
        }
      }
      __syncthreads();
      // a thread's fragments span 2*NT columns: their out-row entries are
      // loaded together, before any use
      for (int g = 0; g < p.RW; ++g) {
        float bv[NT][2];
        for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
          const int d = n0 + n;
          if (i == 0 && q < 2)
            bv[j][q] = d < p.NDP
                           ? __ldg(p.bvec + (size_t)g * V + c * p.NDP + d)
                           : 0.f;
        });
        for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
          if (n0 + n < p.NDP) acc[i][j][q] += wms[r][g] * bv[j][q & 1];
        });
      }
    }
    const bool aligned = ((V | p.NDP) & 1) == 0;
    float* araw = p.araw + (size_t)split * p.B * V;
    if (kSplit) {
      store_tile<TileT>(araw + (size_t)mt * BM * V + (size_t)c * p.NDP + n0,
                        V, min(BM, p.B - mt * BM), min(BN, p.NDP - n0), acc,
                        smem);
      continue;
    }
    float rs[MT][2] = {}, rf[MT][2] = {};
    for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, d = n0 + n;
      acc[i][j][q] *= ob[i][j][q];
      if (row < p.B && d < p.NDP) rs[i][q >> 1] += acc[i][j][q];
      if ((q & 1) && row < p.B)  // columns d - 1, d
        store_pair(araw + (size_t)row * V + (size_t)c * p.NDP + d - 1,
                   acc[i][j][q - 1], acc[i][j][q], p.NDP - (d - 1), aligned);
    });
    if (last)
      for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
        const int d = n0 + n;
        if (mt * BM + r < p.B && d < p.NDP)
          rf[i][q >> 1] +=
              acc[i][j][q] * __ldg(p.final_v + (size_t)c * p.NDP + d);
      });
    const float s = tile_row_sum<TileT>(rs, red);
    float sf = 0.f;
    if (last) sf = tile_row_sum<TileT>(rf, red);
    const int row = mt * BM + threadIdx.x;
    if (threadIdx.x < BM && row < p.B) {
      p.partial[(size_t)row * P + pc] = s;
      if (last) p.partial_f[(size_t)row * P + pc] = sf;
    }
  }
}

// Phase G of frame t (t < T-1), per row part: c_t (every warp reduces the
// row's partials in the same order, so all blocks hold the same bits),
// alphas[t] = araw / c_t, cs[t], and beta of frame t+1 gathered with 1/c_t
// folded in; with a wildcard term, the part's group sums of beta.  The row
// is staged whole in shared memory (kSplit: as the sum of its depth planes
// times obs, c_t then summed from it in one fixed order), or (kPart, a row
// too long for it) only what the part's gather reads, its alphas then read
// through L2.
template <bool kPart, bool kSplit, bool kWild, typename ObsT>
__device__ void fwd_gather(const FwdArgs<ObsT>& p, int t, float* smem,
                           float* red) {
  const int V = p.C * p.NDP;
  const int CS = p.C * p.NSRC;
  const int KP = (p.NSRC + BK - 1) / BK * BK;
  const int P = fwd_partials(p);
  const int H = p.H;
  for (int item = blockIdx.x; item < p.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const int j0 = part_begin(CS, h, H), j1 = part_begin(CS, h + 1, H);
    const float* row = p.araw + (size_t)b * V;
    const float* srow = smem;
    if (kPart) {
      stage_part(smem, p.plan, row, p.NSRC, p.NDP, p.R, p.fd_nsrc,
                 p.fd_ndpos, j0, j1);
      cp_async_commit();
    } else if (!kSplit) {
      srow = stage_async(smem, row, V);
      cp_async_commit();
    }
    const float c = fmaxf(
        kSplit ? stage_split_row(smem, row, p.obs + ((size_t)b * p.T + t) * V,
                                 p.SF, (size_t)p.B * V, V, red)
               : warp_sum_of(p.partial + (size_t)b * P, P),
        kTiny);
    const float rc = 1.f / c;
    cp_async_wait<0>();
    __syncthreads();
    float* out = p.alphas + ((size_t)t * p.B + b) * V;
    const int v1 = part_begin(V, h + 1, H);
    if (kPart) {
      for (int v0 = part_begin(V, h, H) + threadIdx.x; v0 < v1;
           v0 += kThreads * kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = __ldcg(row + min(v0 + u * kThreads, v1 - 1));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (v0 + u * kThreads < v1) out[v0 + u * kThreads] = x[u] * rc;
      }
    } else {
      for (int v = part_begin(V, h, H) + threadIdx.x; v < v1; v += kThreads)
        out[v] = srow[v] * rc;
    }
    float wacc[kMaxR] = {};
    auto store = [&](int j, float x, float ip, int gg) {
      x = x * rc;
      if (p.leaky > 0.f) x += p.leaky * ip;
      const int cc = p.fd_nsrc.div(j);
      p.beta[((size_t)cc * p.Bp + b) * KP + (j - cc * p.NSRC)] = x;
      if (kWild) add_to_group(wacc, gg, x);
    };
    const float* add = p.leaky > 0.f ? p.init_pos : nullptr;
    const int* gid = kWild ? p.gid : nullptr;
    if (kPart)
      gather_part(smem, add, gid, p.R, j0, j1, store);
    else
      gather_row(p.perm, add, gid, srow, p.C, p.NSRC, p.NDP, p.R, p.fd_nsrc,
                 p.fd_ndpos, j0, j1, store);
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
// in part 0 logz = sum_t log c_t + log max(sum alpha_last * final_v, 1e-30)
// (kSplit: the row staged as in phase G, its sums taken from it).
template <bool kSplit, typename ObsT>
__device__ void fwd_finish(const FwdArgs<ObsT>& p, float* smem, float* red) {
  const int V = p.C * p.NDP;
  const int P = fwd_partials(p);
  const int t = p.T - 1;
  const int H = p.H;
  const int lane = threadIdx.x & 31;
  for (int item = blockIdx.x; item < p.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const float* in = p.araw + (size_t)b * V;
    float* out = p.alphas + ((size_t)t * p.B + b) * V;
    const int v1 = part_begin(V, h + 1, H);
    float c, sf = 0.f;
    if (kSplit) {
      c = stage_split_row(smem, in, p.obs + ((size_t)b * p.T + t) * V, p.SF,
                          (size_t)p.B * V, V, red);
      for (int v = threadIdx.x; v < V; v += kThreads)
        sf += smem[v] * __ldg(p.final_v + v);
      sf = block_sum(sf, red);
      in = smem;
    } else {
      c = warp_sum_of(p.partial + (size_t)b * P, P);
    }
    c = fmaxf(c, kTiny);
    const float rc = 1.f / c;
    for (int v0 = part_begin(V, h, H) + threadIdx.x; v0 < v1;
         v0 += kThreads * kUnroll) {
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads;
        x[u] = v < v1 ? (kSplit ? in[v] : __ldcg(in + v)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads;
        if (v < v1) out[v] = x[u] * rc;
      }
    }
    if (h == 0 && threadIdx.x < 32) {
      const float zf =
          (kSplit ? sf : warp_sum_of(p.partial_f + (size_t)b * P, P)) / c;
      float z = 0.f;
      for (int u = lane; u < t; u += 32)
        z += logf(__ldcg(p.cs + (size_t)u * p.B + b));
      z = warp_sum(z);
      if (lane == 0) {
        p.cs[(size_t)t * p.B + b] = c;
        p.logz[b] = (z + logf(c)) + logf(fmaxf(zf, kTiny));
      }
    }
    if (kSplit) __syncthreads();  // smem is the next item's
  }
}

// TileT: the product's tile (BM 64, or 16 at B <= 16); kPart: rows that do
// not fit shared memory, staged part by part; kSplit: the product split
// over its depth (rows staged whole, 64-row tiles); kWild: a wildcard term.
// The host picks the instantiation, so a graph that needs none of them
// runs code that has none.
template <typename TileT, bool kPart, bool kSplit, bool kWild, typename ObsT>
__global__ void __launch_bounds__(kThreads, 1) fwd_scan(FwdArgs<ObsT> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kBMMax][4];
  __shared__ float wms[kBMMax][kMaxR];
  fwd_products<TileT, kSplit, kWild>(p, 0, smem, red, wms);
  for (int t = 1; t < p.T; ++t) {
    grid_sync(p.counter);
    fwd_gather<kPart, kSplit, kWild>(p, t - 1, smem, &red[0][0]);
    grid_sync(p.counter);
    fwd_products<TileT, kSplit, kWild>(p, t, smem, red, wms);
  }
  grid_sync(p.counter);
  fwd_finish<kSplit>(p, smem, &red[0][0]);
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
  const int2* plan;        // [C*NSRC] gather plan of the row parts (kPart)
  int B, T, C, NSRC, NDP, R, LDW, S, RW;  // RW: wildcard groups, 0 = none
  ObsT* grad;              // [B, T, V]
  int Bp, H, w_first;      // padded rows, row parts, W's copies evict_first
                           // (kPart only; plan)
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
  const int Bp = p.Bp;
  const int NDPP = (p.NDP + BK - 1) / BK * BK;
  const float gb = __ldg(p.gbar + b);
  const float rct = 1.f / __ldg(p.cs + (size_t)t * p.B + b);
  const float* al = p.alphas + ((size_t)t * p.B + b) * V;
  const size_t orow = ((size_t)b * p.T + t) * V;
  for (int i0 = v0 + threadIdx.x; i0 < v1; i0 += kThreads * kUnroll) {
    float gg[kUnroll], a[kUnroll], o[kUnroll], bv[kMaxR][kUnroll];
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = min(i0 + u * kThreads, v1 - 1);
      a[u] = __ldg(al + v);
      o[u] = load_obs(p.obs, orow + v);
      if (kWild && t > 0) {
#pragma unroll
        for (int g = 0; g < kMaxR; ++g)
          bv[g][u] = g < p.RW ? __ldg(p.bvec + (size_t)g * V + v) : 0.f;
      }
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
            if (g < p.RW) zacc[g] += x * bv[g][u];
        }
      }
    }
  }
}

// bwd_emit (not the last frame) for a part of a row too long for shared
// memory, with V % 4 == 0: each thread takes four consecutive elements at
// once, their alphas, obs, out-rows and gradient in single 16- or 8-byte
// loads and stores.  A block keeps as many bytes in flight as a 16-wide
// scalar pass with a quarter of the load instructions (the scalar pass
// was bound by the round trips of its 4-byte loads); the perm_inv reads
// and the carrier stores stay one an element.  The part's elements before
// its first multiple of 4 and after its last go one a thread, first and
// last.  The same arithmetic per element as bwd_emit; the wildcard sums in
// this pass's element order.  The carriers go out four at a time too where
// they can (scalar stores 16 bytes apart would write every sector four
// times).
template <bool kWild, typename ObsT>
__device__ void bwd_emit4(const BwdArgs<ObsT>& p, int t, int b, int v0,
                          int v1, float dot, const float* us,
                          float (&zacc)[kMaxR]) {
  // groups of 4 a thread at once: 2 was 1.5-2% faster a scan than 4 or 6
  // on random graphs at the +-1 and ctx shapes, 2-2.5% slower than 4 on
  // the real dens (tools/blocked_den_phases.py, chip_smoke.py)
  constexpr int kG = 2;
  const int V = p.C * p.NDP;
  const int CS = p.C * p.NSRC;
  const int NDPOS = (p.NDP - p.NSRC) / p.R;
  const int NDPP = (p.NDP + BK - 1) / BK * BK;
  const float gb = __ldg(p.gbar + b);
  const float rct = 1.f / __ldg(p.cs + (size_t)t * p.B + b);
  const float* al = p.alphas + ((size_t)t * p.B + b) * V;
  const size_t orow = ((size_t)b * p.T + t) * V;
  auto g_of = [&](int v) {  // u through perm_inv, or the loop slice
    const int c = p.fd_ndp.div(v), d = v - c * p.NDP;
    const int pi = __ldg(p.perm_inv + c * NDPOS + p.fd_ndpos.mod(d));
    return d < p.R * NDPOS ? pi : c * p.NSRC + (d - p.R * NDPOS);
  };
  auto vcar_at = [&](int v) {
    const int c = p.fd_ndp.div(v);
    return p.vcar + ((size_t)c * p.Bp + b) * NDPP + (v - c * p.NDP);
  };
  // the gradient of element v; its carrier into x
  auto emit = [&](float a, float o, float gg, const float* bv, float& x) {
    const float bar = gg - dot + gb;
    const float gr = __fdividef(a * bar, fmaxf(o, kObsFloor));
    x = (bar * rct) * o;
    if (kWild && t > 0) {
#pragma unroll
      for (int g = 0; g < kMaxR; ++g)
        if (g < p.RW) zacc[g] += x * bv[g];
    }
    return gr;
  };
  auto scalar = [&](int v) {
    float bv[kMaxR];
#pragma unroll
    for (int g = 0; g < kMaxR; ++g)
      bv[g] = kWild && g < p.RW ? __ldg(p.bvec + (size_t)g * V + v) : 0.f;
    const int j = g_of(v);
    float x;
    store_grad(p.grad, orow + v,
               emit(__ldg(al + v), load_obs(p.obs, orow + v),
                    j < CS ? us[j] : 0.f, bv, x));
    if (t > 0) *vcar_at(v) = x;
  };
  const int a0 = min(v1, (v0 + 3) & ~3), a1 = max(a0, v1 & ~3);
  if ((int)threadIdx.x < a0 - v0) scalar(v0 + threadIdx.x);
  for (int q0 = a0 / 4 + threadIdx.x; q0 < a1 / 4; q0 += kThreads * kG) {
    float a[kG][4], o[kG][4], bv[kG][4][kMaxR], gg[kG][4];
    int j[kG][4];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const int v = 4 * min(q0 + k * kThreads, a1 / 4 - 1);
      const float4 x = __ldg(reinterpret_cast<const float4*>(al + v));
      a[k][0] = x.x, a[k][1] = x.y, a[k][2] = x.z, a[k][3] = x.w;
      load_obs4(p.obs, orow + v, o[k]);
#pragma unroll
      for (int g = 0; g < kMaxR; ++g) {
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kWild && g < p.RW)
          w = __ldg(reinterpret_cast<const float4*>(p.bvec + (size_t)g * V +
                                                    v));
        bv[k][0][g] = w.x, bv[k][1][g] = w.y, bv[k][2][g] = w.z,
        bv[k][3][g] = w.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) j[k][e] = g_of(v + e);
    }
#pragma unroll
    for (int k = 0; k < kG; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) gg[k][e] = j[k][e] < CS ? us[j[k][e]] : 0.f;
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      if (q0 + k * kThreads >= a1 / 4) continue;
      const int v = 4 * (q0 + k * kThreads);
      float gr[4], x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gr[e] = emit(a[k][e], o[k][e], gg[k][e], bv[k][e], x[e]);
      store_grad4(p.grad, orow + v, gr);
      if (t > 0) {
        // one 16- or two 8-byte stores where the four lie in one
        // superblock's carrier row (neighbouring lanes then write
        // neighbouring 16 bytes), else one an element
        float* dst = vcar_at(v);
        const uintptr_t al16 = reinterpret_cast<uintptr_t>(dst) & 15;
        if (p.fd_ndp.div(v) == p.fd_ndp.div(v + 3) && (al16 & 7) == 0) {
          if (al16 == 0) {
            *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2],
                                                          x[3]);
          } else {
            reinterpret_cast<float2*>(dst)[0] = make_float2(x[0], x[1]);
            reinterpret_cast<float2*>(dst)[1] = make_float2(x[2], x[3]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) *vcar_at(v + e) = x[e];
        }
      }
    }
  }
  if ((int)threadIdx.x < v1 - a1) scalar(a1 + threadIdx.x);
}

// Starts the asynchronous copies of alpha_t's row b for beta0's gather of
// part h into shared memory at base (16-byte aligned): the whole row, or
// (kPart) what the part's gather reads.  Returns where it starts.
template <bool kPart, typename ObsT>
__device__ const float* bwd_stage_alpha(const BwdArgs<ObsT>& p, int t, int b,
                                        int h, float* base) {
  const int V = p.C * p.NDP;
  const int CS = p.C * p.NSRC;
  const float* arow = p.alphas + ((size_t)t * p.B + b) * V;
  if (!kPart) return stage_async(base, arow, V);
  stage_part(base, p.plan, arow, p.NSRC, p.NDP, p.R, p.fd_nsrc, p.fd_ndpos,
             part_begin(CS, h, p.H), part_begin(CS, h + 1, p.H));
  return base;
}

// beta0 of frame t (the forward's gather of alpha_t, no leaky term) for
// part h of row b, from what bwd_stage_alpha staged at arow; on a wildcard
// graph, the part's group sums of beta0 into w0part.
template <bool kPart, bool kWild, typename ObsT>
__device__ void bwd_beta0(const BwdArgs<ObsT>& p, int t, int b, int h,
                          const float* arow, float* red) {
  const int CS = p.C * p.NSRC;
  const int j0 = part_begin(CS, h, p.H), j1 = part_begin(CS, h + 1, p.H);
  float wacc[kMaxR] = {};
  auto store = [&](int j, float x, float, int gg) {
    p.beta0[(size_t)b * CS + j] = x;
    if (kWild) add_to_group(wacc, gg, x);
  };
  const int* gid = kWild ? p.gid : nullptr;
  if (kPart)
    gather_part(arow, nullptr, gid, p.R, j0, j1, store);
  else
    gather_row(p.perm, nullptr, gid, arow, p.C, p.NSRC, p.NDP, p.R,
               p.fd_nsrc, p.fd_ndpos, j0, j1, store);
  if (kWild) store_group_sums(p, wacc, wild_at(p, p.w0part, t, b, h), red);
}

// Frame T-1, per row part: S = sum(alpha_last * final_v) over the whole
// row (a block sum, the same bits in every block), zfin = max(S, 1e-30),
// g = gbar * final_v / zfin, dot = gbar * S / zfin; then beta0 of T-2.
template <bool kPart, bool kWild, typename ObsT>
__device__ void bwd_last(const BwdArgs<ObsT>& p, float* smem, float* red) {
  const int V = p.C * p.NDP;
  const int H = p.H;
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
    const float* arow = nullptr;
    if (p.T > 1) {
      arow = bwd_stage_alpha<kPart>(p, p.T - 2, b, h, smem);
      cp_async_commit();
    }
    float zacc[kMaxR] = {};
    const int v0 = part_begin(V, h, H), v1 = part_begin(V, h + 1, H);
    bwd_emit<true, kWild>(p, p.T - 1, b, v0, v1, gb * (S / zfin), nullptr,
                          1.f / zfin, zacc);
    if (kWild && p.T > 1)
      store_group_sums(p, zacc, wild_at(p, p.zpart, p.T - 1, b, h), red);
    cp_async_wait<0>();
    __syncthreads();
    if (p.T > 1) bwd_beta0<kPart, kWild>(p, p.T - 2, b, h, arow, red);
    __syncthreads();
  }
}

// Phase P of frame t: u = v_{t+1} @ W^T partials and the partial dots
// sum_j u[j] * beta0_t[j].
template <typename TileT, bool kHint, typename ObsT>
__device__ void bwd_products(const BwdArgs<ObsT>& p, float* smem,
                             float (*red)[4]) {
  constexpr int BM = TileT::BM, MT = TileT::MT;
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
    tile_product<true, TileT, kHint>(
        p.vcar + ((size_t)c * Bp + mt * BM) * NDPP, NDPP,
        p.w + ((size_t)c * p.NSRC + n0) * p.LDW, p.LDW, min(BN, p.NSRC - n0),
        p.NDP, k_begin, k_end, smem, acc, p.w_first);
    // every load of the epilogue is issued before its first store
    float bz[MT][NT][4];
    for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, s = n0 + n;
      bz[i][j][q] = row < p.B && s < p.NSRC
                        ? __ldcg(p.beta0 + (size_t)row * CS +
                                 (size_t)c * p.NSRC + s)
                        : 0.f;
    });
    float rs[MT][2] = {};
    const bool aligned = ((CS | p.NSRC) & 1) == 0;
    for_each_frag<TileT>([&](int i, int j, int q, int r, int n) {
      const int row = mt * BM + r, s = n0 + n;
      if (row < p.B && s < p.NSRC) rs[i][q >> 1] += acc[i][j][q] * bz[i][j][q];
      if ((q & 1) && row < p.B)  // sources s - 1, s
        store_pair(p.upart + ((size_t)split * p.B + row) * CS +
                       (size_t)c * p.NSRC + s - 1,
                   acc[i][j][q - 1], acc[i][j][q], p.NSRC - (s - 1),
                   aligned);
    });
    const float s = tile_row_sum<TileT>(rs, red);
    const int row = mt * BM + threadIdx.x;
    if (threadIdx.x < BM && row < p.B) p.dpart[(size_t)row * Pd + pd] = s;
  }
}

// Phase F of frame t, per row part: the row's dot (every warp reduces the
// partials in the same order), u = the sum of the S partials in order,
// staged in shared memory beside alpha_{t-1}'s row (kPart: what the part's
// gather reads of it); on a wildcard graph z[g] = v_{t+1} . vec[g] and the group sums
// of beta0_t from the previous phase F's parts, z[g] added to each member's
// u and sum_g z[g] * (group sum) to the dot; g_t through perm_inv
// (sentinel C*NSRC reads zero), broadcast to the R enter slots, and the
// loop slice; the outputs of frame t; beta0 of frame t-1.
template <bool kPart, bool kWild, typename ObsT>
__device__ void bwd_frame(const BwdArgs<ObsT>& p, int t, float* smem,
                          float* red) {
  const int V = p.C * p.NDP;
  const int CS = p.C * p.NSRC;
  const int Pd = p.C * ((p.NSRC + BN - 1) / BN) * p.S;
  const int H = p.H;
  float* us = smem;
  for (int item = blockIdx.x; item < p.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const float* arow = nullptr;
    if (t > 0) {
      arow = bwd_stage_alpha<kPart>(p, t - 1, b, h, smem + (CS + 3) / 4 * 4);
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
    // rows staged by part: u in 16-byte loads (C*NSRC % 4 == 0; the sums
    // per element as below), its slots' groups in 16-byte loads too
    const int c4 = kPart && (CS & 3) == 0 ? CS / 4 : 0;
    for (int q0 = threadIdx.x; q0 < c4; q0 += kThreads * 2) {
      float4 x[2] = {};
      for (int s0 = 0; s0 < p.S; s0 += kMaxS) {
        float4 y[kMaxS][2];
#pragma unroll
        for (int sp = 0; sp < kMaxS; ++sp) {
          const float4* up = reinterpret_cast<const float4*>(
              p.upart + ((size_t)(s0 + sp) * p.B + b) * CS);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            y[sp][u] = s0 + sp < p.S
                           ? __ldcg(up + min(q0 + u * kThreads, c4 - 1))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int sp = 0; sp < kMaxS; ++sp)
          if (s0 + sp < p.S) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              x[u].x += y[sp][u].x, x[u].y += y[sp][u].y;
              x[u].z += y[sp][u].z, x[u].w += y[sp][u].w;
            }
          }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int q = q0 + u * kThreads;
        if (q >= c4) continue;
        if (kWild) {
          const int4 gg = __ldg(reinterpret_cast<const int4*>(p.gid) + q);
#pragma unroll
          for (int g = 0; g < kMaxR; ++g) {
            if (gg.x == g) x[u].x += z[g];
            if (gg.y == g) x[u].y += z[g];
            if (gg.z == g) x[u].z += z[g];
            if (gg.w == g) x[u].w += z[g];
          }
        }
        reinterpret_cast<float4*>(us)[q] = x[u];
      }
    }
    for (int j0 = 4 * c4 + threadIdx.x; j0 < CS; j0 += kThreads * kUnroll) {
      // the loads of up to kMaxS splits at once, then the sums in order
      float x[kUnroll] = {};
      for (int s0 = 0; s0 < p.S; s0 += kMaxS) {
        float y[kMaxS][kUnroll];
#pragma unroll
        for (int sp = 0; sp < kMaxS; ++sp) {
          const float* up = p.upart + ((size_t)(s0 + sp) * p.B + b) * CS;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            y[sp][u] = s0 + sp < p.S
                           ? __ldcg(up + min(j0 + u * kThreads, CS - 1))
                           : 0.f;
        }
#pragma unroll
        for (int sp = 0; sp < kMaxS; ++sp)
          if (s0 + sp < p.S) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) x[u] += y[sp][u];
          }
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
    cp_async_wait<0>();
    __syncthreads();
    float zacc[kMaxR] = {};
    const int v0 = part_begin(V, h, H), v1 = part_begin(V, h + 1, H);
    if (kPart && (V & 3) == 0)
      bwd_emit4<kWild>(p, t, b, v0, v1, dot, us, zacc);
    else
      bwd_emit<false, kWild>(p, t, b, v0, v1, dot, us, 0.f, zacc);
    if (kWild && t > 0)
      store_group_sums(p, zacc, wild_at(p, p.zpart, t, b, h), red);
    if (t > 0) bwd_beta0<kPart, kWild>(p, t - 1, b, h, arow, red);
    __syncthreads();
  }
}

// TileT: the product's tile; kPart: alpha rows that do not fit beside u in
// shared memory, staged part by part; kWild: a wildcard term.  The host
// picks the instantiation.
template <typename TileT, bool kPart, bool kWild, typename ObsT>
__global__ void __launch_bounds__(kThreads, 1) bwd_scan(BwdArgs<ObsT> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kBMMax][4];
  bwd_last<kPart, kWild>(p, smem, &red[0][0]);
  for (int t = p.T - 2; t >= 0; --t) {
    grid_sync(p.counter);
    bwd_products<TileT, kPart>(p, smem, red);
    grid_sync(p.counter);
    bwd_frame<kPart, kWild>(p, t, smem, &red[0][0]);
  }
}

// ------------------------------------------------------------------ host

size_t pad_up(size_t n) { return (n + kPad - 1) / kPad * kPad; }

// Blocks of a persistent launch of `kernel`: every block resident.  Asked
// of the runtime once per kernel and device, then kept (kGridCache entries
// at most): a scan plans and launches without the occupancy queries.
constexpr int kGridCache = 256;

struct GridEntry {
  const void* kernel;
  int dev, grid;
};

cudaError_t persistent_grid(const void* kernel, int* grid) {
  static std::mutex mu;
  static GridEntry cache[kGridCache];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i)
      if (cache[i].kernel == kernel && cache[i].dev == dev) {
        *grid = cache[i].grid;
        return cudaSuccess;
      }
  }
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           kSmemBytes)) != cudaSuccess)
    return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, kSmemBytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  if (used < kGridCache) cache[used++] = {kernel, dev, *grid};
  return cudaSuccess;
}

// The instantiation of one direction, obs type and tile rows at the plan's
// choices: rows staged by part or whole, the forward split over its depth
// (64-row tiles, rows staged whole) or not, with or without the wildcard
// term.  Null for a combination the plan never makes.
template <bool kFwd, typename ObsT, int kBM>
const void* unit_kernel(bool part, bool split, bool wild) {
  using TileT = Tile<kBM>;
  if constexpr (kFwd) {
    if constexpr (kBM == 64) {
      if (split && !part)
        return wild ? (const void*)fwd_scan<TileT, false, true, true, ObsT>
                    : (const void*)fwd_scan<TileT, false, true, false, ObsT>;
    }
    if (split) return nullptr;
    if (part)
      return wild ? (const void*)fwd_scan<TileT, true, false, true, ObsT>
                  : (const void*)fwd_scan<TileT, true, false, false, ObsT>;
    return wild ? (const void*)fwd_scan<TileT, false, false, true, ObsT>
                : (const void*)fwd_scan<TileT, false, false, false, ObsT>;
  } else {
    if (split) return nullptr;
    return part ? (wild ? (const void*)bwd_scan<TileT, true, true, ObsT>
                        : (const void*)bwd_scan<TileT, true, false, ObsT>)
                : (wild ? (const void*)bwd_scan<TileT, false, true, ObsT>
                        : (const void*)bwd_scan<TileT, false, false, ObsT>);
  }
}

// One unit's entry: with args null, the persistent grid of the kernel the
// choices name into *grid; else its cooperative launch on `stream` with
// args, refused unless its grid is *grid (the plan's).
template <bool kFwd, typename ObsT, int kBM>
int unit_entry(int part, int split, int wild, void** args, int* grid,
               void* stream) {
  const void* kernel = unit_kernel<kFwd, ObsT, kBM>(part, split, wild);
  if (!kernel) return (int)cudaErrorInvalidValue;
  int g = 0;
  const cudaError_t err = persistent_grid(kernel, &g);
  if (err != cudaSuccess) return (int)err;
  if (!args) {
    *grid = g;
    return 0;
  }
  if (g != *grid) return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchCooperativeKernel(
      kernel, g, kThreads, args, kSmemBytes,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// The instantiations are compiled as eight translation units at once
// (cuda_build.py passes BD_UNIT = 0..7 and links them): unit u holds the
// kernels of one direction (u < 4: forward), obs type (u & 2: bf16) and
// tile rows (u & 1: 16), and unit 0 the C API too.  Without BD_UNIT one
// unit holds everything (tools/blocked_den_phases.py builds it so).
extern "C" {
int blocked_den_unit_0(int, int, int, void**, int*, void*);
int blocked_den_unit_1(int, int, int, void**, int*, void*);
int blocked_den_unit_2(int, int, int, void**, int*, void*);
int blocked_den_unit_3(int, int, int, void**, int*, void*);
int blocked_den_unit_4(int, int, int, void**, int*, void*);
int blocked_den_unit_5(int, int, int, void**, int*, void*);
int blocked_den_unit_6(int, int, int, void**, int*, void*);
int blocked_den_unit_7(int, int, int, void**, int*, void*);
}

#define BD_UNIT_ENTRY(u, fwd, obs, bm)                                     \
  extern "C" int blocked_den_unit_##u(int part, int split, int wild,       \
                                      void** args, int* grid, void* st) {  \
    return unit_entry<fwd, obs, bm>(part, split, wild, args, grid, st);    \
  }
#if !defined(BD_UNIT) || BD_UNIT == 0
BD_UNIT_ENTRY(0, true, float, 64)
#endif
#if !defined(BD_UNIT) || BD_UNIT == 1
BD_UNIT_ENTRY(1, true, float, 16)
#endif
#if !defined(BD_UNIT) || BD_UNIT == 2
BD_UNIT_ENTRY(2, true, __nv_bfloat16, 64)
#endif
#if !defined(BD_UNIT) || BD_UNIT == 3
BD_UNIT_ENTRY(3, true, __nv_bfloat16, 16)
#endif
#if !defined(BD_UNIT) || BD_UNIT == 4
BD_UNIT_ENTRY(4, false, float, 64)
#endif
#if !defined(BD_UNIT) || BD_UNIT == 5
BD_UNIT_ENTRY(5, false, float, 16)
#endif
#if !defined(BD_UNIT) || BD_UNIT == 6
BD_UNIT_ENTRY(6, false, __nv_bfloat16, 64)
#endif
#if !defined(BD_UNIT) || BD_UNIT == 7
BD_UNIT_ENTRY(7, false, __nv_bfloat16, 16)
#endif

#if !defined(BD_UNIT) || BD_UNIT == 0
namespace {

using UnitFn = int (*)(int, int, int, void**, int*, void*);

UnitFn unit_of(bool fwd, bool bf16, int bm) {
  static const UnitFn units[8] = {blocked_den_unit_0, blocked_den_unit_1,
                                  blocked_den_unit_2, blocked_den_unit_3,
                                  blocked_den_unit_4, blocked_den_unit_5,
                                  blocked_den_unit_6, blocked_den_unit_7};
  return units[(fwd ? 0 : 4) + (bf16 ? 2 : 0) + (bm == 16 ? 1 : 0)];
}

// Shapes the kernels take: enter slots, 32-bit element counts, the
// adjoint's u row fits the shared memory of the row passes, W rows padded
// to a multiple of 4 floats, at most kMaxR wildcard groups.
bool shape_ok(int B, int C, int NSRC, int NDP, int R, int LDW, int RW) {
  const long long V = (long long)C * NDP;
  return B >= 1 && R >= 1 && NDP > NSRC && (NDP - NSRC) % R == 0 &&
         B * V < (1LL << 31) && (long long)C * NSRC + 8 <= kSmemFloats &&
         LDW % 4 == 0 && LDW >= NDP && RW >= 0 && RW <= kMaxR;
}

// Plan failures (negative, beside the CUDA error codes).
constexpr int kShapeRefused = -1;  // shape_ok is false
constexpr int kPartTooLong = -2;   // a row part outgrows shared memory

// The adjoint's splits of its product over d (kchunks stages of BK) with
// `tiles` output tiles: as many as fill the grid in one wave.  Where one split per
// tile already fills more than half the grid, the S <= 4 with the fewest
// waves per unit of depth, ceil(tiles * S / grid) / S (the adjoint at the
// +-1 shape: 88 tiles on 132 SMs, S = 3, two waves of a third of the depth
// each, against one wave of the whole depth on 88 SMs).
int splits_for(int grid, int tiles, int kchunks) {
  int s = grid / tiles;
  if (s < 2) {
    s = 1;
    for (int c = 2; c <= 4; ++c) {
      const long long waves_c = ((long long)tiles * c + grid - 1) / grid;
      const long long waves_s = ((long long)tiles * s + grid - 1) / grid;
      if (waves_c * s < waves_s * c) s = c;
    }
  }
  return s > kchunks ? kchunks : s;
}

// What the host picks for one scan (the graph's shape and the device
// decide; nothing else): the product's tile rows bm (16 at B <= 16, where a
// 64-row tile would be three quarters padding, else 64); the depth splits
// (forward: over NSRC; adjoint: over NDP); whether rows are staged part by
// part (kPart: the whole row, beside u in the adjoint, does not fit the
// row passes' shared memory); the row parts h, as many as keep B*h items
// within one per block (at most kMaxH), raised where a staged part would
// not fit; whether the adjoint copies W evict_first (w_first).
// The forward splits only 64-row tiles of rows staged whole (a split row
// is summed as it is staged; a row past shared memory has more than 320
// tiles, over two waves, already).
struct Plan {
  int bm, splits, part, h, grid, w_first;
};

int tile_rows_for(int B) { return B <= 16 ? 16 : 64; }

// Whether a W of w_floats does not fit this device's L2.
bool past_l2(long long w_floats) {
  int dev = 0, l2 = 0;
  return cudaGetDevice(&dev) == cudaSuccess &&
         cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev) ==
             cudaSuccess &&
         w_floats * 4 > l2;
}

int make_plan(bool fwd, int B, int C, int NSRC, int NDP, int R, int RW,
              Plan* pl) {
  const int LDW = NDP + (-NDP & 3);
  if (!shape_ok(B, C, NSRC, NDP, R, LDW, RW)) return kShapeRefused;
  const long long V = (long long)C * NDP, CS = (long long)C * NSRC;
  const long long below = fwd ? 0 : (CS + 3) / 4 * 4;  // u, in the adjoint
  pl->bm = tile_rows_for(B);
  pl->part = below + V + 4 > kSmemFloats;
  // the grid of the float32 instantiation (every one is one block of
  // 200 KB a SM; the launch checks its own)
  const int rc = unit_of(fwd, false, pl->bm)(pl->part, 0, RW > 0, nullptr,
                                             &pl->grid, nullptr);
  if (rc != 0) return rc;
  pl->h = std::max(1, std::min(kMaxH, pl->grid / B));
  while (pl->part &&
         below + (R + 1) * ((CS + pl->h - 1) / pl->h) > kSmemFloats) {
    if (++pl->h > kMaxH) return kPartTooLong;
  }
  const int mtiles = (B + pl->bm - 1) / pl->bm;
  if (fwd) {
    // only where one split per tile leaves half the grid idle: at B = 16
    // three waves of quarter-depth tiles took longer than one wave of whole
    // ones, and a split row is summed as it is staged
    const int tiles = mtiles * C * ((NDP + BN - 1) / BN);
    pl->splits = pl->part || pl->bm != 64
                     ? 1
                     : std::min(std::max(1, pl->grid / tiles),
                                (NSRC + BK - 1) / BK);
  } else {
    pl->splits = splits_for(pl->grid, mtiles * C * ((NSRC + BN - 1) / BN),
                            (NDP + BK - 1) / BK);
  }
  // the adjoint's instantiations of rows staged by part carry the hint
  pl->w_first = !fwd && pl->part && past_l2(CS * LDW);
  return 0;
}

// Scratch of each direction, laid out in one place: the sentinel check of
// chip_smoke.py surrounds exactly `total` floats with its bands.
struct FwdLayout {
  size_t counter, beta, araw, partial, partial_f, wpart, total;
};

FwdLayout fwd_layout(int B, int C, int NSRC, int NDP, int RW, int bm,
                     int SF) {
  const size_t Bp = (B + bm - 1) / bm * bm;
  const size_t KP = (NSRC + BK - 1) / BK * BK;
  const size_t PS = (size_t)C * ((NDP + BN - 1) / BN);
  FwdLayout l;
  l.counter = 0;
  l.beta = kPad;
  l.araw = l.beta + pad_up(C * Bp * KP);
  l.partial = l.araw + pad_up((size_t)SF * B * C * NDP);
  l.partial_f = l.partial + pad_up(B * PS);
  l.wpart = l.partial_f + pad_up(B * PS);
  l.total = l.wpart + pad_up((size_t)B * kMaxH * RW);
  return l;
}

template <typename ObsT>
int fwd_impl(FwdArgs<ObsT> p, float* scratch, cudaStream_t st) {
  if (!shape_ok(p.B, p.C, p.NSRC, p.NDP, p.R, p.LDW, p.RW))
    return kShapeRefused;
  Plan pl;
  const int rc = make_plan(true, p.B, p.C, p.NSRC, p.NDP, p.R, p.RW, &pl);
  if (rc != 0) return rc;
  if (pl.part && !p.plan) return (int)cudaErrorInvalidValue;
  const FwdLayout l =
      fwd_layout(p.B, p.C, p.NSRC, p.NDP, p.RW, pl.bm, pl.splits);
  p.Bp = (p.B + pl.bm - 1) / pl.bm * pl.bm;
  p.SF = pl.splits;
  p.H = pl.h;
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
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, l.araw * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  return unit_of(true, sizeof(ObsT) == 2, pl.bm)(
      pl.part, pl.splits > 1, p.RW > 0, args, &pl.grid, st);
}

struct BwdLayout {
  size_t counter, vcar, upart, dpart, beta0, zpart, w0part, total;
};

BwdLayout bwd_layout(int B, int C, int NSRC, int NDP, int S, int RW,
                     int bm) {
  const size_t Bp = (B + bm - 1) / bm * bm;
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

template <typename ObsT>
int bwd_impl(BwdArgs<ObsT> p, float* scratch, cudaStream_t st) {
  if (!shape_ok(p.B, p.C, p.NSRC, p.NDP, p.R, p.LDW, p.RW))
    return kShapeRefused;
  Plan pl;
  const int rc = make_plan(false, p.B, p.C, p.NSRC, p.NDP, p.R, p.RW, &pl);
  if (rc != 0) return rc;
  if (pl.part && !p.plan) return (int)cudaErrorInvalidValue;
  const BwdLayout l =
      bwd_layout(p.B, p.C, p.NSRC, p.NDP, pl.splits, p.RW, pl.bm);
  p.S = pl.splits;
  p.w_first = pl.w_first;
  p.Bp = (p.B + pl.bm - 1) / pl.bm * pl.bm;
  p.H = pl.h;
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
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, l.upart * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  return unit_of(false, sizeof(ObsT) == 2, pl.bm)(pl.part, 0, p.RW > 0, args,
                                                  &pl.grid, st);
}

}  // namespace

extern "C" {

// Wildcard groups the kernels take.
int blocked_den_max_groups() { return kMaxR; }

// The plan of the forward (fwd != 0) or adjoint scan of a graph on this
// device: out = {tile rows, depth splits, rows staged part by part, row
// parts, grid, the adjoint's W copies evict_first}.  Returns 0, a CUDA
// error, -1 for a shape the kernels do not take, or -2 where a staged row
// part would not fit shared memory.  The launches plan for themselves
// with this code.
int blocked_den_plan(int fwd, int B, int C, int NSRC, int NDP, int R, int RW,
                     int* out) {
  Plan pl;
  const int rc = make_plan(fwd != 0, B, C, NSRC, NDP, R, RW, &pl);
  if (rc == 0) {
    out[0] = pl.bm;
    out[1] = pl.splits;
    out[2] = pl.part;
    out[3] = pl.h;
    out[4] = pl.grid;
    out[5] = pl.w_first;
  }
  return rc;
}

// Floats of scratch the forward (fwd != 0) or the adjoint takes at its
// plan; 0 where there is no plan (the launch then fails as the plan does).
long long blocked_den_scratch(int fwd, int B, int C, int NSRC, int NDP, int R,
                              int RW) {
  Plan pl;
  if (make_plan(fwd != 0, B, C, NSRC, NDP, R, RW, &pl) != 0) return 0;
  return (long long)(fwd ? fwd_layout(B, C, NSRC, NDP, RW, pl.bm, pl.splits)
                               .total
                         : bwd_layout(B, C, NSRC, NDP, pl.splits, RW, pl.bm)
                               .total);
}

// Forward scan.  obs [B,T,V] (f32, or bf16 when obs_bf16); w [C,NSRC,LDW]
// with LDW a multiple of 4 >= NDP and zeros past NDP; RW wildcard groups
// (0: none, gid and bvec unused): gid [C*NSRC] each slot's group or -1,
// bvec [RW,V] the groups' out-rows; plan [C*NSRC] int pairs, the gather
// plan of the plan's row parts where it stages rows by part (else unused).
// Writes the normalized alphas [T,B,V], the scales cs [T,B] and logz [B].
// scratch: blocked_den_scratch(1, ...) floats.  One memset and one
// cooperative launch on `stream`; no host sync, no allocation.
int blocked_den_fwd(const void* obs, int obs_bf16, const float* w,
                    const int* perm, const float* init_pos,
                    const float* init_v, const float* final_v,
                    const int* gid, const float* bvec, const int* plan,
                    float leaky, int B, int T, int C, int NSRC, int NDP,
                    int R, int LDW, int RW, float* alphas, float* cs,
                    float* logz, float* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* pairs = reinterpret_cast<const int2*>(plan);
  if (obs_bf16) {
    FwdArgs<__nv_bfloat16> p{static_cast<const __nv_bfloat16*>(obs), w, perm,
                             init_pos, init_v, final_v, gid, bvec, pairs,
                             leaky, B, T, C, NSRC, NDP, R, LDW, RW, alphas,
                             cs, logz};
    return fwd_impl(p, scratch, st);
  }
  FwdArgs<float> p{static_cast<const float*>(obs), w, perm, init_pos, init_v,
                   final_v, gid, bvec, pairs, leaky, B, T, C, NSRC, NDP, R,
                   LDW, RW, alphas, cs, logz};
  return fwd_impl(p, scratch, st);
}

// Adjoint scan.  Writes grad [B,T,V] = d(sum_b gbar_b logz_b)/d obs in
// obs's dtype; w, RW, gid, bvec and plan (the adjoint's row parts') as for
// the forward; scratch: blocked_den_scratch(0, ...) floats.  One memset
// and one cooperative launch on `stream`; no host sync, no allocation.
int blocked_den_bwd(const void* obs, int obs_bf16, const float* w,
                    const int* perm, const int* perm_inv,
                    const float* final_v, const float* alphas,
                    const float* cs, const float* gbar, const int* gid,
                    const float* bvec, const int* plan, int B, int T, int C,
                    int NSRC, int NDP, int R, int LDW, int RW, void* grad,
                    float* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* pairs = reinterpret_cast<const int2*>(plan);
  if (obs_bf16) {
    BwdArgs<__nv_bfloat16> p{static_cast<const __nv_bfloat16*>(obs), w, perm,
                             perm_inv, final_v, alphas, cs, gbar, gid, bvec,
                             pairs, B, T, C, NSRC, NDP, R, LDW, 0, RW,
                             static_cast<__nv_bfloat16*>(grad)};
    return bwd_impl(p, scratch, st);
  }
  BwdArgs<float> p{static_cast<const float*>(obs), w, perm, perm_inv,
                   final_v, alphas, cs, gbar, gid, bvec, pairs, B, T, C,
                   NSRC, NDP, R, LDW, 0, RW, static_cast<float*>(grad)};
  return bwd_impl(p, scratch, st);
}

}  // extern "C"
#endif  // the C API, in unit 0
