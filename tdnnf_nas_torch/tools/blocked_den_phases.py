"""Phase timeline of the blocked-den kernels on one GPU.

The forward and the adjoint each run a whole scan in one persistent
launch, so a profiler sees one kernel.  This tool builds an instrumented
copy of ``csrc/blocked_den.cu`` in which block 0 reads ``%globaltimer``
after every grid barrier, runs both scans with bf16 obs on random blocked
graphs at the shapes of ``chip_smoke.py``'s blocked dens (``SHAPES``:
the flagship at B=64, T=50; LHUC's den at B=16; the planted table's at
B=48, T=24; the committed +-1 den at B=64, with a one-group wildcard term
and rows staged by part; the pm1 contender at B=48, T=40), prints the
plan the library picks for each, and the mean time of each phase: the
forward's product and gather phases, the adjoint's product and frame
phases.  A phase's time runs from one barrier's exit to the next, so it
holds the slowest block and one barrier.

``--variant`` builds a diagnostic copy with one part cut out, to read what
that part costs (the outputs are then wrong):

  base         the kernels as they are;
  one_pass     one TF32 product (hi x hi) instead of three;
  no_loads     no copies into the shared-memory ring;
  no_mainloop  no block product at all (epilogue and barrier alone);
  no_rowpass   no gather or frame phase (barrier alone);
  splits_floor the depth splits as grid / tiles alone (the adjoint's 1
               at the +-1 shape), without the fewest-waves choice;
  no_evict_first  the adjoint's W copies without the L2 policy
               evict_first (W past L2: the pm1 and ctx shapes); against
               base, what the policy saves.

With ``base``, ``no_mainloop`` and ``no_rowpass`` together it also prints
each shape's per-frame split: the product's main loop, its epilogue, one
barrier and the row pass.

Usage: python -m tdnnf_nas_torch.tools.blocked_den_phases
           [--variant NAME[,NAME...]] [--shape NAME[,NAME...]|all]

(one nvcc per variant, started together; every shape runs on each)
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np

_STAMP = ("  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
          "    unsigned long long ts;\n"
          "    asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(ts));\n"
          "    g_stamps[g_nstamp++] = ts;\n  }\n")
_READ = """
extern "C" int phases_read(unsigned long long* out, int* n) {
  cudaMemcpyFromSymbol(n, g_nstamp, sizeof(int));
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  const int zero = 0;
  cudaMemcpyToSymbol(g_nstamp, &zero, sizeof(int));
  return (int)cudaDeviceSynchronize();
}
"""
# the first two of the three passes, cut out by one_pass
_MMA3 = ("        for (int j = 0; j < NT; ++j)"
         " mma_tf32(acc[i][j], al[i], bh[j]);\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < MT; ++i)\n"
         "#pragma unroll\n"
         "        for (int j = 0; j < NT; ++j)"
         " mma_tf32(acc[i][j], ah[i], bl[j]);\n")
VARIANTS = {
    "base": [],
    "one_pass": [(_MMA3, "        for (int j = 0; j < NT; ++j) {}\n")],
    "no_loads": [
        ("    if (s < nk) load(s, k_begin + s * BK);",
         "    if (s < 0) load(s, k_begin + s * BK);"),
        ("    if (nx < nk) load(nx % kStages, k_begin + nx * BK);",
         "    if (nx < 0) load(nx % kStages, k_begin + nx * BK);")],
    "no_mainloop": [
        ("      tile_product<false, TileT>(",
         "      if (t < 0) tile_product<false, TileT>("),
        ("    tile_product<true, TileT, kHint>(\n",
         "    if (tile < 0) tile_product<true, TileT, kHint>(\n")],
    "no_rowpass": [
        ("    fwd_gather<kPart, kSplit, kWild>(p, t - 1, smem, &red[0][0]);",
         ""),
        ("    bwd_frame<kPart, kWild>(p, t, smem, &red[0][0]);", "")],
    "splits_floor": [("  if (s < 2) {\n    s = 1;",
                      "  if (s < 1) {\n    s = 1;")],
    "no_evict_first": [("  pl->w_first = !fwd && pl->part && past_l2(",
                        "  pl->w_first = 0 && pl->part && past_l2(")],
}


# (B, T, C, NSRC, NDPOS, R, pdfs, wildcard groups): the dens of
# chip_smoke.py's blocked checks, from the V and GFLOP it prints for each
# (C = V / NDP, NSRC = flops / (2 B (T-1) V), R = 4 enter slots):
# flagship, phase 2 (V = 18,830); b16, phase 9's LHUC den at B = 16 (V =
# 14,568); b48, phase 15's planted-table den at B = 48, T = 24 (V = 4,850);
# pm1, phase 10's committed +-1 den (V = 61,468); ctx, phase 16's pm1
# contender at B = 48, T = 40 (V = 58,044)
SHAPES = {"flagship": (64, 50, 7, 538, 538, 4, 6034, 0),
          "b16": (16, 50, 6, 492, 484, 4, 6034, 0),
          "b48": (48, 24, 2, 477, 487, 4, 430, 0),
          "pm1": (64, 50, 22, 558, 559, 4, 430, 1),
          "ctx": (48, 40, 21, 544, 555, 4, 430, 1)}


def instrumented_source(src: str, variant: str) -> str:
    """The kernels' source with barrier stamps and the variant's cuts."""
    edits = [
        ("#include <mutex>\n\nnamespace {\n",
         "#include <mutex>\n\n__device__ unsigned long long g_stamps[8192];\n"
         "__device__ int g_nstamp;\nnamespace {\n"),
        ("    __threadfence();\n  }\n  __syncthreads();\n}\n",
         "    __threadfence();\n  }\n  __syncthreads();\n" + _STAMP + "}\n"),
        ("fwd_scan(FwdArgs<ObsT> p) {\n",
         "fwd_scan(FwdArgs<ObsT> p) {\n" + _STAMP),
        ("bwd_scan(BwdArgs<ObsT> p) {\n",
         "bwd_scan(BwdArgs<ObsT> p) {\n" + _STAMP),
    ] + VARIANTS[variant]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"instrumentation point not found: {old!r}")
        src = src.replace(old, new)
    return src + _READ


def _graph_inputs(torch, shape, dev):
    """The random blocked graph of the card tests at ``shape``, bf16 obs
    and the adjoint's seed."""
    from tdnnf_nas_torch.graphs.den_graph import random_blocked_graph
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    b, t, c, nsrc, ndpos, r, npdf, groups = shape
    rng = np.random.RandomState(0)
    g = BlockedDenGraph.from_host(
        random_blocked_graph(rng, c, nsrc, ndpos, r, npdf, groups=groups), dev)
    logits = torch.tensor(rng.randn(b, t, npdf).astype(np.float32) * 2,
                          device=dev)
    obs = torch.exp(torch.clamp(logits - logits.amax(-1, keepdim=True),
                                min=-30.0))
    obs_v = obs.to(torch.bfloat16).index_select(-1, g.pdf_virtual)
    gbar = torch.rand(b, device=dev) + 0.5
    return g, obs_v.contiguous(), gbar


def _phase_means(torch, stamps, fn, reps: int, fwd: bool):
    """(first phase, product phase, row phase) in us, means over frames and
    reps; a phase runs from one barrier's exit to the next."""
    means = []
    for _ in range(reps):
        stamps()
        fn()
        torch.cuda.synchronize()
        d = np.diff(stamps()) / 1e3
        if fwd:  # P0, then (G, P) per frame
            means.append((d[0], d[2::2].mean(), d[1::2].mean()))
        else:  # last frame, then (P, F) per frame
            means.append((d[0], d[1::2].mean(), d[2::2].mean()))
    return np.mean(means, axis=0)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="base",
                    help="comma-separated, of " + ", ".join(sorted(VARIANTS)))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shape", default="flagship",
                    help="comma-separated, of " + ", ".join(SHAPES)
                    + ", or all")
    args = ap.parse_args()
    variants = args.variant.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    for name, known in (("variant", VARIANTS), ("shape", SHAPES)):
        bad = [x for x in (variants if name == "variant" else shapes)
               if x not in known]
        if bad:
            ap.error(f"unknown {name}: {', '.join(bad)}")
    if not torch.cuda.is_available():
        print("blocked_den_phases: no CUDA device", file=sys.stderr)
        return 2
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for variant in variants:
        srcs[variant] = cuda_build.BUILD_DIR / f"blocked_den_phases_{variant}.cu"
        srcs[variant].write_text(
            instrumented_source(bdc._SRC.read_text(), variant))
    cuda_build.build(tuple(srcs.values()))  # one nvcc per variant, at once
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    table = {}  # (variant, shape, direction) -> (first, product, rows)
    for variant in variants:
        bdc._SRC = srcs[variant]
        bdc._library.cache_clear()
        bdc.plan.cache_clear()
        bdc._scratch.cache_clear()
        lib = bdc._library()
        lib.phases_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

        def stamps():
            out = (ctypes.c_ulonglong * 8192)()
            n = ctypes.c_int()
            if lib.phases_read(out, ctypes.byref(n)) != 0:
                raise RuntimeError("phases_read failed")
            return np.array(out[: n.value], dtype=np.float64)

        for shape in shapes:
            b, t, c, nsrc, ndpos, r, _, groups = SHAPES[shape]
            g, obs_v, gbar = _graph_inputs(torch, SHAPES[shape], dev)
            print(f"variant {variant}; shape {shape}: B={b} T={t} C={c} "
                  f"NSRC={nsrc} V={c * (r * ndpos + nsrc)} wildcard "
                  f"groups={groups}, bf16 obs ({gpu})", flush=True)
            for fwd in (True, False):
                print(f"[{'fwd' if fwd else 'bwd'} plan] "
                      f"{bdc.plan(0, fwd, b, c, nsrc, r * ndpos + nsrc, r, groups)}",
                      flush=True)
            _, al, cs = bdc.blocked_den_fwd_cuda(obs_v, g, 0.1)
            runs = {"fwd": lambda: bdc.blocked_den_fwd_cuda(obs_v, g, 0.1),
                    "bwd": lambda: bdc.blocked_den_bwd_cuda(obs_v, g, al, cs,
                                                            gbar)}
            for name, fn in runs.items():
                first, prod, rows = table[variant, shape, name] = \
                    _phase_means(torch, stamps, fn, args.reps, name == "fwd")
                label = "gather" if name == "fwd" else "frame"
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                for _ in range(args.reps):
                    fn()
                ev1.record()
                torch.cuda.synchronize()
                print(f"[{name}] first phase {first:.2f} us; product phase "
                      f"{prod:.2f} us, {label} phase {rows:.2f} us (means "
                      f"over {t - 1} frames, {args.reps} runs); "
                      f"{ev0.elapsed_time(ev1) / args.reps:.3f} ms per scan "
                      f"(CUDA events)", flush=True)
            del g, obs_v, gbar, al, cs
    if {"base", "no_mainloop", "no_rowpass"} <= set(variants):
        # the per-frame split: main loop = base - no_mainloop product
        # phases; epilogue = no_mainloop product phase - one barrier;
        # barrier = no_rowpass row phase; row pass = base row phase - one
        # barrier
        for shape in shapes:
            for name in ("fwd", "bwd"):
                base = table["base", shape, name]
                bare = table["no_mainloop", shape, name]
                barrier = table["no_rowpass", shape, name][2]
                print(f"[split {shape} {name}] us a frame: main loop "
                      f"{base[1] - bare[1]:.2f}, epilogue "
                      f"{bare[1] - barrier:.2f}, barrier {barrier:.2f}, row "
                      f"pass {base[2] - barrier:.2f} ({gpu})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
