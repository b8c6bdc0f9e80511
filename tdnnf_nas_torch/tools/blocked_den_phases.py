"""Phase timeline of the blocked-den kernels on one GPU.

The forward and the adjoint each run a whole scan in one persistent
launch, so a profiler sees one kernel.  This tool builds an instrumented
copy of ``csrc/blocked_den.cu`` in which block 0 reads ``%globaltimer``
after every grid barrier, runs both scans at the flagship shape (B=64,
T=50, C=7, NSRC=538, NDPOS=538, R=4, bf16 obs) on a random blocked graph
(``--shape pm1``: at the committed +-1 den's shape of ``chip_smoke.py``
phase 10, C=22, NSRC=558, NDPOS=559, 430 pdfs, with a one-group wildcard
term; its rows are read through L2), and prints the mean time of each phase: the forward's product and gather
phases, the adjoint's product and frame phases.  A phase's time runs from
one barrier's exit to the next, so it holds the slowest block and one
barrier.

``--variant`` builds a diagnostic copy with one part cut out, to read what
that part costs (the outputs are then wrong):

  base         the kernels as they are;
  one_pass     one TF32 product (hi x hi) instead of three;
  no_loads     no copies into the shared-memory ring;
  no_mainloop  no block product at all (epilogue and barrier alone);
  no_rowpass   no gather or frame phase (barrier alone);
  splits_floor the adjoint's d-splits as grid / tiles alone (1 at the
               +-1 shape), without the fewest-waves choice.

Usage: python -m tdnnf_nas_torch.tools.blocked_den_phases [--variant NAME]
           [--shape flagship|pm1]
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
        ("      tile_product<false>(p.beta",
         "      if (t < 0) tile_product<false>(p.beta"),
        ("    tile_product<true>(p.vcar",
         "    if (tile < 0) tile_product<true>(p.vcar")],
    "no_rowpass": [
        ("    fwd_gather<kL2, kWild>(p, t - 1, smem, &red[0][0]);", ""),
        ("    bwd_frame<kL2, kWild>(p, t, smem, &red[0][0]);", "")],
    "splits_floor": [("  if (s < 2) {\n    s = 1;",
                      "  if (s < 1) {\n    s = 1;")],
}


# (B, T, C, NSRC, NDPOS, R, pdfs, wildcard groups)
SHAPES = {"flagship": (64, 50, 7, 538, 538, 4, 6034, 0),
          "pm1": (64, 50, 22, 558, 559, 4, 430, 1)}


def instrumented_source(src: str, variant: str) -> str:
    """The kernels' source with barrier stamps and the variant's cuts."""
    edits = [
        ("namespace {\n",
         "__device__ unsigned long long g_stamps[8192];\n"
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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shape", default="flagship", choices=sorted(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("blocked_den_phases: no CUDA device", file=sys.stderr)
        return 2
    from tdnnf_nas_torch.graphs.den_graph import random_blocked_graph
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import cuda_build
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    src = cuda_build.BUILD_DIR / f"blocked_den_phases_{args.variant}.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(instrumented_source(bdc._SRC.read_text(), args.variant))
    bdc._SRC = src
    bdc._library.cache_clear()
    lib = bdc._library()
    lib.phases_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    def stamps():
        out = (ctypes.c_ulonglong * 8192)()
        n = ctypes.c_int()
        if lib.phases_read(out, ctypes.byref(n)) != 0:
            raise RuntimeError("phases_read failed")
        return np.array(out[: n.value], dtype=np.float64)

    # the random blocked graph of the card tests, at the chosen shape
    b, t, c, nsrc, ndpos, r, npdf, groups = SHAPES[args.shape]
    rng = np.random.RandomState(0)
    host = random_blocked_graph(rng, c, nsrc, ndpos, r, npdf, groups=groups)
    v = c * (r * ndpos + nsrc)
    dev = torch.device("cuda", 0)
    g = BlockedDenGraph.from_host(host, dev)
    logits = torch.tensor(rng.randn(b, t, npdf).astype(np.float32) * 2,
                          device=dev)
    obs = torch.exp(torch.clamp(logits - logits.amax(-1, keepdim=True),
                                min=-30.0))
    obs_v = obs.to(torch.bfloat16).index_select(-1, g.pdf_virtual)
    obs_v = obs_v.contiguous()
    gbar = torch.rand(b, device=dev) + 0.5
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"variant {args.variant}; shape {args.shape}: B={b} T={t} C={c} "
          f"NSRC={nsrc} V={v} wildcard groups={groups}, bf16 obs ({gpu})")

    _, al, cs = bdc.blocked_den_fwd_cuda(obs_v, g, 0.1)
    runs = {"fwd": lambda: bdc.blocked_den_fwd_cuda(obs_v, g, 0.1),
            "bwd": lambda: bdc.blocked_den_bwd_cuda(obs_v, g, al, cs, gbar)}
    for name, fn in runs.items():
        means = []
        for _ in range(args.reps):
            stamps()
            fn()
            torch.cuda.synchronize()
            d = np.diff(stamps()) / 1e3  # us between barrier exits
            if name == "fwd":  # P0, then (G, P) per frame
                means.append((d[0], d[2::2].mean(), d[1::2].mean()))
            else:  # last frame, then (P, F) per frame
                means.append((d[0], d[1::2].mean(), d[2::2].mean()))
        first, prod, rows = np.mean(means, axis=0)
        label = "gather" if name == "fwd" else "frame"
        print(f"[{name}] first phase {first:.2f} us; product phase "
              f"{prod:.2f} us, {label} phase {rows:.2f} us (means over "
              f"{t - 1} frames, {args.reps} runs)")
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(args.reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        print(f"[{name}] {ev0.elapsed_time(ev1) / args.reps:.3f} ms per "
              f"scan (CUDA events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
