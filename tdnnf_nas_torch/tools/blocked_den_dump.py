"""Dump, or compare, the blocked-den kernels' outputs on fixed inputs.

``dump OUT`` runs ``blocked_den_fwd`` and ``blocked_den_bwd`` on the card
on seeded random graphs without a wildcard term, at the flagship shape
(B = 64, T = 50, C = 7, NSRC = 538, NDPOS = 538, R = 4, 6,034 pdfs) and at
LHUC's B = 16, in float32 and bf16 obs, and saves logZ, alphas, scales
and the obs gradient to OUT (torch.save).  ``compare A B`` says whether
two dumps are equal bit for bit, tensor by tensor.  Run ``dump`` from two
checkouts of the repository in one call to hold one version's kernels to
another's (run this file by its path with the other checkout first on
PYTHONPATH, so that its package is the one imported).

Usage:
    python -m tdnnf_nas_torch.tools.blocked_den_dump dump OUT
    python -m tdnnf_nas_torch.tools.blocked_den_dump compare A B
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# (B, T, C, NSRC, NDPOS, R, pdfs)
SHAPES = ((64, 50, 7, 538, 538, 4, 6034), (16, 50, 7, 538, 538, 4, 6034),
          (5, 9, 2, 70, 40, 3, 50))


def dump(path: str) -> None:
    from tdnnf_nas_torch.graphs.den_graph import random_blocked_graph
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    dev = torch.device("cuda", 0)
    out = {}
    for shape in SHAPES:
        b, t, c, nsrc, ndpos, r, p = shape
        rng = np.random.RandomState(0)
        g = BlockedDenGraph.from_host(
            random_blocked_graph(rng, c, nsrc, ndpos, r, p), dev)
        logits = torch.tensor(rng.randn(b, t, p).astype(np.float32) * 2,
                              device=dev)
        obs = torch.exp(torch.clamp(logits - logits.amax(-1, keepdim=True),
                                    min=-30.0))
        gbar = torch.tensor(rng.rand(b).astype(np.float32) + 0.5,
                            device=dev)
        for dt in (torch.float32, torch.bfloat16):
            obs_v = obs.to(dt).index_select(-1, g.pdf_virtual).contiguous()
            z, al, cs = bdc.blocked_den_fwd_cuda(obs_v, g, 0.1)
            gr = bdc.blocked_den_bwd_cuda(obs_v, g, al, cs, gbar)
            key = f"{shape}/{str(dt).replace('torch.', '')}"
            out[key] = {n: x.cpu() for n, x in (
                ("logz", z), ("alphas", al), ("cs", cs), ("grad", gr))}
    torch.cuda.synchronize()
    torch.save(out, path)
    print(f"dumped {len(out)} runs to {path}")


def compare(a: str, b: str) -> int:
    da, db = torch.load(a), torch.load(b)
    ok = sorted(da) == sorted(db)
    for key in sorted(da):
        for name, x in da[key].items():
            same = key in db and torch.equal(x, db[key][name])
            ok &= same
            print(f"{key} {name}: {'equal' if same else 'DIFFERENT'}")
    print("bit for bit: " + ("yes" if ok else "no"))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
