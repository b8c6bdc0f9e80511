"""Per-component times of the train step on the card: model forward and
forward+backward, the dense denominator's forward and forward+grad, and
the numerator's forward+grad (port of ``scripts/profile_components.py``).

The set-up is the reference's: 8 utterances of 46 phones, a
``BiphoneTree`` asked for 6,034 - 46 forward leaves, which it caps at
the 46 x 47 left biphones (2,208 pdfs with the 46 self-loops, not the
6,034 the reference's names suggest), its bigram den (S = 2,208), the
flagship 7q on those pdfs at B = 64 and W = 50 output frames (bf16
compute, zero i-vectors) with features from ``RandomState(0)``;
the numerator is 64 per-sequence graphs of S = 80 states
(``RandomState(1)``) with an all-ones mask.

Where it differs from the reference:

- the den goes through the dense-den kernels
  (``ops/dense_den_cuda.pallas_forward_score``, the step's own path for
  a dense den) where the reference timed the XLA scan ``forward_score``;
  the numerator through ``ops/fwdbwd.forward_score``, the plain torch
  scan with its autograd adjoint;
- each figure is timed in ``--rounds`` rounds of ``--n`` calls closed by
  ``torch.cuda.synchronize()``; the median round is written under the
  reference's printed label, every round under ``rounds``;
- the figures go to ``--out DIR/profile_components.json`` (the reference
  only prints them), with the den's states and pdfs.

Usage: python3 -m tdnnf_nas_torch.tools.profile_components --out DIR
       [--n N] [--rounds N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.tools.timing import Figures, write_json

NUM_PHONES = 46
NUM_PDFS = 6034
NUM_UTTS = 8
# the reference's printed labels (scripts/profile_components.py:54-84)
KEYS = ("model_fwd", "model_fwd_bwd", "den_forward", "den_fwd_grad",
        "num_fwd_grad")


def den_setup():
    """(tree, den StateGraph) of the reference's set-up (``:31-41``)."""
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (BiphoneTree, build_denominator_graph,
                                        estimate_phone_lm)

    corpus_cfg = SyntheticCorpusConfig(num_utts=NUM_UTTS,
                                       num_phones=NUM_PHONES, feat_dim=40,
                                       min_phones=10, max_phones=30)
    _, phone_seqs, _, topo = make_synthetic_corpus(corpus_cfg)
    tree = BiphoneTree(NUM_PHONES, num_leaves=NUM_PDFS - NUM_PHONES)
    lm = estimate_phone_lm(phone_seqs, NUM_PHONES)
    return tree, build_denominator_graph(lm, topo, tree)


def numerator_graphs(b: int, w: int, num_pdfs: int, s_num: int = 80):
    """(trans, state_pdf, init, final, mask) of ``:75-85``, numpy."""
    rng = np.random.RandomState(1)
    tr = rng.rand(b, s_num, s_num).astype(np.float32)
    tr /= tr.sum(-1, keepdims=True)
    spdf = rng.randint(0, num_pdfs, (b, s_num)).astype(np.int32)
    init = np.ones((b, s_num), np.float32) / s_num
    final = np.ones((b, s_num), np.float32)
    mask = np.ones((b, w, s_num), np.float32)
    return tr, spdf, init, final, mask


def run(out_dir=None, batch: int = 64, width: int = 50, model_overrides=(),
        n: int = 10, rounds: int = 3, device=DEFAULT_DEVICE) -> dict:
    """Times the five components; returns (and writes) the figures."""
    from tdnnf_nas_torch.models import (TdnnfModelConfig, apply_model,
                                        chunk_input_frames, init_model)
    from tdnnf_nas_torch.ops.dense_den_cuda import pallas_forward_score
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays, forward_score
    from tdnnf_nas_torch.train.optimizer import tree_paths

    dev = resolve_device(device)
    tree, den = den_setup()
    den_arr = DenGraphArrays.from_graph(den, dev)
    print(f"den graph: S={den.num_states} P={den.num_pdfs}", flush=True)

    cfg = TdnnfModelConfig(num_pdfs=tree.num_pdfs).replace(
        **dict(model_overrides))
    params, bn = init_model(cfg, torch.Generator().manual_seed(0), dev)
    t_in = chunk_input_frames(cfg, width)
    feats = torch.from_numpy(np.random.RandomState(0).randn(
        batch, t_in, cfg.feat_dim).astype(np.float32)).to(dev)
    ivecs = torch.zeros(batch, cfg.ivector_dim, device=dev)
    figs = Figures(dev)

    def fwd():
        with torch.no_grad():
            return apply_model(cfg, params, bn, feats, ivecs, train=False)[0]

    figs.timed("model_fwd", "model fwd", fwd, n=n, rounds=rounds)
    leaves = [x for _, x in tree_paths(params)]
    for p in leaves:
        p.requires_grad_(True)

    def fwd_bwd():
        loss = apply_model(cfg, params, bn, feats, ivecs, train=True)[0].sum()
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    figs.timed("model_fwd_bwd", "model fwd+bwd", fwd_bwd, n=n, rounds=rounds)
    for p in leaves:
        p.requires_grad_(False)

    obs = fwd().float()
    graph = (den_arr.trans, den_arr.state_pdf, den_arr.init, den_arr.final)

    def den_fwd():
        with torch.no_grad():
            return pallas_forward_score(obs, *graph, leaky_coef=0.1)

    figs.timed("den_forward", "den forward", den_fwd, n=n, rounds=rounds)
    o = obs.detach().requires_grad_(True)

    def den_grad():
        logz = pallas_forward_score(o, *graph, leaky_coef=0.1)
        return torch.autograd.grad(logz.sum(), o)[0]

    figs.timed("den_fwd_grad", "den fwd+grad", den_grad, n=n, rounds=rounds)

    num = [torch.from_numpy(a).to(dev)
           for a in numerator_graphs(batch, width, tree.num_pdfs)]

    def num_grad():
        logz = forward_score(o, num[0], num[1], num[2], num[3], mask=num[4])
        return torch.autograd.grad(logz.sum(), o)[0]

    figs.timed("num_fwd_grad", "num fwd+grad", num_grad, n=n, rounds=rounds)
    res = figs.as_json(den_states=int(den.num_states),
                       num_pdfs=int(den.num_pdfs),
                       tree_pdfs=int(tree.num_pdfs), batch=batch,
                       chunk_width=width)
    write_json(out_dir, "profile_components.json", res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for profile_components.json")
    ap.add_argument("--n", type=int, default=10, help="calls per round")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    run(args.out, n=args.n, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
