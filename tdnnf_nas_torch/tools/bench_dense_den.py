"""The dense-den kernel pair against the plain torch scan at the dense
den's real sizes (port of ``scripts/bench_pallas_den.py``).

B, T, S, P = 64, 50, 2,208, 6,034: a random [S, S] transition matrix
(5% of the arcs and a 0.3 self-loop, rows normalised), state pdfs, init
and final, and [B, T, P] observations, all from ``RandomState(0)`` in the
reference's order.  It checks the kernels against the plain scan (logZ
relative error, gradient max abs error), then times the forward and the
forward+grad of each.

Where it differs from the reference:

- the hand-written CUDA pair (``ops/dense_den_cuda.pallas_forward_score``:
  ``dense_den_fwd`` and ``dense_den_bwd`` in ``csrc/dense_den.cu``) stands
  where the reference's Pallas kernels stood, and the plain torch scan
  (``ops/fwdbwd.forward_score``, autograd adjoint) where its XLA scan
  stood; on the CPU both run their plain versions;
- each time is the median of ``--rounds`` rounds of ``--n`` calls closed by
  ``torch.cuda.synchronize()`` (every round under ``rounds``), and the
  figures go to ``--out DIR/bench_dense_den.json`` under the reference's
  printed labels (it only prints them): ``fwd_rel_err``,
  ``grad_max_abs_err``, ``plain_fwd`` / ``kernel_fwd`` (its "XLA fwd" /
  "Pallas fwd") and ``plain_fwd_grad`` / ``kernel_fwd_grad``, in ms.

Usage: python3 -m tdnnf_nas_torch.tools.bench_dense_den --out DIR
       [--n N] [--rounds N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.tools.timing import Figures, write_json

SIZES = (64, 50, 2208, 6034)  # b, t, s, p (scripts/bench_pallas_den.py:31)


def random_den(s: int, p: int, seed: int = 0):
    """(trans, state_pdf, init, final, rng) of ``:30-39``, numpy; the rng
    goes on to draw the observations."""
    rng = np.random.RandomState(seed)
    trans = rng.rand(s, s).astype(np.float32)
    trans *= rng.rand(s, s) < 0.05
    trans[np.arange(s), np.arange(s)] += 0.3
    trans /= trans.sum(1, keepdims=True)
    state_pdf = rng.randint(0, p, s).astype(np.int32)
    init = (rng.rand(s) / s).astype(np.float32)
    init /= init.sum()
    final = np.ones(s, np.float32)
    return trans, state_pdf, init, final, rng


def run(out_dir=None, sizes=SIZES, n: int = 10, rounds: int = 3,
        device=DEFAULT_DEVICE) -> dict:
    from tdnnf_nas_torch.ops.dense_den_cuda import pallas_forward_score
    from tdnnf_nas_torch.ops.fwdbwd import forward_score

    dev = resolve_device(device)
    b, t, s, p = sizes
    *graph, rng = random_den(s, p)
    obs = torch.from_numpy(rng.randn(b, t, p).astype(np.float32)).to(dev)
    trans, state_pdf, init, final = (torch.from_numpy(a).to(dev)
                                     for a in graph)
    args = (trans, state_pdf.long(), init, final)

    def plain(o):
        return forward_score(o, *args, leaky_coef=0.1)

    def kernel(o):
        return pallas_forward_score(o, *args, leaky_coef=0.1)

    def fwd_of(score):
        def fn():
            with torch.no_grad():
                return score(obs)
        return fn

    def grad_of(score):
        def fn():
            o = obs.detach().requires_grad_(True)
            return torch.autograd.grad(score(o).sum(), o)[0]
        return fn

    z_x, z_p = fwd_of(plain)(), fwd_of(kernel)()
    err = float(((z_x - z_p).abs() / z_x.abs().clamp(min=1.0)).max())
    g_x, g_p = grad_of(plain)(), grad_of(kernel)()
    gerr = float((g_x - g_p).abs().max())
    print(f"fwd rel err: {err:.2e}\ngrad max abs err: {gerr:.2e}", flush=True)
    figs = Figures(dev)
    for key, label, fn in (
            ("plain_fwd", "plain  fwd", fwd_of(plain)),
            ("kernel_fwd", "kernel fwd", fwd_of(kernel)),
            ("plain_fwd_grad", "plain  fwd+grad", grad_of(plain)),
            ("kernel_fwd_grad", "kernel fwd+grad", grad_of(kernel))):
        figs.timed(key, label, fn, n=n, rounds=rounds)
    res = figs.as_json(fwd_rel_err=err, grad_max_abs_err=gerr,
                       sizes=dict(zip("btsp", sizes)))
    write_json(out_dir, "bench_dense_den.json", res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for bench_dense_den.json")
    ap.add_argument("--n", type=int, default=10, help="calls per round")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    run(args.out, n=args.n, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
