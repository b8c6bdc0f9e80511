"""Phase timeline of the dense-den kernels on one GPU.

Each direction runs a whole scan in one persistent launch, so a profiler
sees one kernel.  This tool builds an instrumented copy of
``csrc/dense_den.cu`` in which block 0 reads ``%globaltimer`` at the
kernel's start and after every grid barrier, runs both scans on a random
dense graph (B=64 and B=32, T=50, S=2,208: the dense training step's and
the search's shapes), and prints the mean time of each phase: the
product phase P and the row phase R of a frame.  A phase's time runs from
one barrier's exit to the next, so it holds the slowest block and one
barrier.  It also times each scan by CUDA events beside the scan's
products alone in cuBLAS (float32, TF32 off), in ``--rounds`` rounds that
alternate the two, and prints every round's pair.

``--variant`` builds a diagnostic copy with one part cut out, to read what
that part costs (the outputs are then wrong):

  base         the kernels as they are;
  one_pass     one TF32 product (hi x hi) instead of three;
  no_mainloop  no product at all (A stage, epilogue and barrier);
  no_copy      no copy of the A stage into shared memory;
  no_store     no store of the product's partials;
  no_rowpass   no row phase (barrier alone);
  alpha_copy4  the adjoint epilogue's alpha tile copied 4 bytes at a time
               (the outputs stay right: this one times a slower copy).

Usage: python -m tdnnf_nas_torch.tools.dense_den_phases [--variant NAME]
       [--reps N] [--rounds N]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np

from tdnnf_nas_torch.tools.blocked_den_phases import _READ, _STAMP

# the first two of the three passes, cut out by one_pass
_MMA2 = ("        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], "
         "bh[j]);\n")
_MMA3 = ("        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], "
         "bl[j]);\n")
VARIANTS = {
    "base": [],
    "one_pass": [(_MMA2, "        for (int j = 0; j < NT; ++j) {}\n"),
                 (_MMA3, "        for (int j = 0; j < NT; ++j) {}\n")],
    "no_mainloop": [("    mainloop<kFwd, kResident>(p, as,",
                     "    if (c0 < 0) mainloop<kFwd, kResident>(p, as,")],
    "no_copy": [("            stage_copy(p, r0, rows, c0, c1, a, lda);",
                 "            if (c0 < 0) stage_copy(p, r0, rows, c0, c1, a, "
                 "lda);")],
    "no_store": [("      store_tile(p, p.part + ",
                  "      if (d < 0) store_tile(p, p.part + ")],
    "no_rowpass": [("    if (kFwd)\n      fwd_rows(p, t);\n    else\n"
                    "      bwd_rows(p, t);\n", "")],
    "alpha_copy4": [("  if ((p.S & 3) == 0 &&\n      (reinterpret_cast<uintptr_t>"
                     "(p.alpha_in) & 15) == 0) {", "  if (false) {")],
}


def instrumented_source(src: str, variant: str) -> str:
    """The kernels' source with barrier stamps and the variant's cuts."""
    edits = [
        ("namespace {\n",
         "__device__ unsigned long long g_stamps[8192];\n"
         "__device__ int g_nstamp;\nnamespace {\n"),
        ("    __threadfence();\n  }\n  __syncthreads();\n}\n",
         "    __threadfence();\n  }\n  __syncthreads();\n" + _STAMP + "}\n"),
        ("scan(Args p) {\n", "scan(Args p) {\n" + _STAMP),
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
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_den_phases: no CUDA device", file=sys.stderr)
        return 2
    from tdnnf_nas_torch.ops import cuda_build
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc

    src = cuda_build.BUILD_DIR / f"dense_den_phases_{args.variant}.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(instrumented_source(ddc._SRC.read_text(), args.variant))
    ddc._SRC = src
    ddc._library.cache_clear()
    lib = ddc._library()
    lib.phases_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    torch.backends.cuda.matmul.allow_tf32 = False

    def stamps():
        out = (ctypes.c_ulonglong * 8192)()
        n = ctypes.c_int()
        if lib.phases_read(out, ctypes.byref(n)) != 0:
            raise RuntimeError("phases_read failed")
        return np.array(out[: n.value], dtype=np.float64)

    def ms(fn, reps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        fn()
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    # the random dense graph of the card tests, at the flagship size
    t, s = 50, 2208
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    trans = rng.rand(s, s) * (rng.rand(s, s) < 0.3)
    trans[np.arange(s), np.arange(s)] += 0.3
    trans /= trans.sum(axis=1, keepdims=True)
    init = rng.rand(s)
    init /= init.sum()
    trans, init = (torch.tensor(a, dtype=torch.float32, device=dev)
                   for a in (trans, init))
    final = torch.ones(s, device=dev)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"variant {args.variant}; T={t} S={s} ({gpu})")
    for b in (64, 32):
        pl = ddc._device_plan(dev, b, s)
        logits = torch.tensor(rng.randn(b, t, s).astype(np.float32) * 2,
                              device=dev)
        obs = torch.clamp(logits - logits.amax(-1, keepdim=True), min=-30.0)
        gbar = torch.rand(b, device=dev) + 0.5
        _, al, cs = ddc.dense_den_fwd_cuda(obs, trans, init, final, 0.1)
        runs = {"fwd": lambda: ddc.dense_den_fwd_cuda(obs, trans, init,
                                                      final, 0.1),
                "bwd": lambda: ddc.dense_den_bwd_cuda(obs, trans, final,
                                                      al, cs, gbar)}
        x = torch.rand(b, s, device=dev)
        y = torch.empty_like(x)
        products = {"fwd": lambda: [torch.mm(x, trans, out=y)
                                    for _ in range(t - 1)],
                    "bwd": lambda: [torch.mm(x, trans.T, out=y)
                                    for _ in range(t - 1)]}
        for name, fn in runs.items():
            means = []
            for _ in range(args.reps):
                stamps()
                fn()
                torch.cuda.synchronize()
                d = np.diff(stamps()) / 1e3  # us between barrier exits
                # the first phases (the forward's once-per-scan leaky
                # product has a barrier of its own), then (P, R) per frame
                lead = 2 if name == "fwd" else 1
                means.append((d[:lead].sum(), d[lead::2].mean(),
                              d[lead + 1::2].mean()))
            first, prod, rows = np.mean(means, axis=0)
            print(f"[{name} B={b}] first phase {first:.2f} us; product "
                  f"phase {prod:.2f} us, row phase {rows:.2f} us (means "
                  f"over {t - 1} frames, {args.reps} runs; tiles "
                  f"{pl.n_out}x{pl.n_depth} of {pl.out_w}x{pl.depth_w}, "
                  f"resident {pl.resident})")
            pairs = [(ms(fn, args.reps), ms(products[name], args.reps))
                     for _ in range(args.rounds)]
            kern, cublas = np.array(pairs).T
            print(f"[{name} B={b}] ms per scan by round, kernel / cuBLAS "
                  f"products alone: " + ", ".join(
                      f"{k:.3f} / {c:.3f}" for k, c in pairs)
                  + f"; medians {np.median(kern):.3f} / "
                  f"{np.median(cublas):.3f} (CUDA events, {args.reps} "
                  f"scans a round)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
