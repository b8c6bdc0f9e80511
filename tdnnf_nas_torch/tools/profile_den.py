"""The production train step's pieces on the card: model forward+backward,
the den forward and forward+backward, the observation gather, and the
whole step (port of ``scripts/profile_den.py``).

The set-up is the reference's production one: 768 utterances of 46
phones, the 6,034-leaf left-2 tree clustered on them, the 4-gram phone
LM with 2,000 extra states composed into the den (``prepare_data``),
chunks of 50 frames with at most 40 phones, B = 64 with i-vectors from
``RandomState(3)``, the flagship 7q in bf16 and Adam.

Where it differs from the reference:

- the reference times ``forward_score_factored`` on ``bundle.den_arrays``
  (``:124-137``), but its ``prepare_data`` now exports the den as a
  ``BlockedDenGraph`` (``tdnnf_nas_tpu/recipes/chain_recipes.py:174``),
  which ``forward_score_factored`` cannot read, so the script stops
  there.  The port times the den the step uses: ``forward_score_blocked``,
  whose scans are the blocked-den kernels (``csrc/blocked_den.cu``);
- ``gather_fwd_bwd`` gathers the blocked den's per-slot observations
  (``pdf_virtual``, [B, T, V]), the gather the step runs, where the
  reference gathered the factored den's ``state_pdf``;
- ``pos_matmul_scan_fwd`` (``:158-181``) is left out: it times the hi/lo
  bf16 split matmul of the factored den, a TPU workaround the port does
  not have;
- each figure is the median of ``--rounds`` rounds of ``--n`` calls closed
  by ``torch.cuda.synchronize()`` (every round under ``rounds``); the
  figures, in ms under the reference's keys, go to
  ``--out DIR/profile_den.json``.

``run(bundle=, tree=)`` takes a set-up built already (``chip_smoke.py``
phase 17 hands it phase 1's).

Usage: python3 -m tdnnf_nas_torch.tools.profile_den --out DIR [--n N]
       [--rounds N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.tools.timing import Figures, write_json

NUM_PHONES = 46
# the reference's keys (scripts/profile_den.py:113-184), without
# pos_matmul_scan_fwd
KEYS = ("model_fwd_bwd", "den_fwd", "den_fwd_bwd", "gather_fwd_bwd", "full")


def production_setup(num_utts: int = 768, num_leaves: int = 6034 - NUM_PHONES,
                     extra_lm_states: int = 2000):
    """(tree, bundle, {"tree": s, "den": s}) of the production set-up
    (``scripts/profile_den.py:53-67``, ``scripts/bench_triphone_den.py:
    39-60``)."""
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (accumulate_triphone_stats,
                                        build_clustered_triphone_tree)
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data

    corpus_cfg = SyntheticCorpusConfig(
        num_utts=num_utts, num_phones=NUM_PHONES, feat_dim=40, min_phones=10,
        max_phones=30, mean_dur=4.0, context_shift=1.0, seed=0)
    t0 = time.perf_counter()
    utts, phone_seqs, _, topo = make_synthetic_corpus(corpus_cfg)
    stats = accumulate_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        NUM_PHONES, corpus_cfg.frame_subsampling_factor)
    tree = build_clustered_triphone_tree(stats, num_leaves=num_leaves)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = prepare_data(utts, phone_seqs, tree, topo, NUM_PHONES,
                          phone_lm_order=4,
                          num_extra_lm_states=extra_lm_states)
    return tree, bundle, {"tree": t_tree, "den": time.perf_counter() - t0}


def _requiring_grad(tree):
    """A copy of a nested dict of tensors whose leaves require grad."""
    return {k: _requiring_grad(v) if isinstance(v, dict)
            else v.detach().requires_grad_(True) for k, v in tree.items()}


def run(out_dir=None, bundle=None, tree=None, batch: int = 64,
        chunk_width: int = 50, model_overrides=(), n: int = 8,
        rounds: int = 3, device=DEFAULT_DEVICE) -> dict:
    """Times the pieces on ``bundle`` (the production set-up, built when
    not given); returns (and writes) the figures."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.models import TdnnfModelConfig, apply_model
    from tdnnf_nas_torch.ops.fwdbwd import forward_score_blocked
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)
    from tdnnf_nas_torch.train.optimizer import tree_paths

    dev = resolve_device(device)
    if bundle is None:
        tree, bundle, _ = production_setup()
    model_cfg = TdnnfModelConfig(num_pdfs=tree.num_pdfs).replace(
        **dict(model_overrides))
    trainer_cfg = TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=1e-4, num_steps=100000))
    chunks = bundle.egs(model_cfg, chunk_width=chunk_width,
                        max_phones_per_chunk=40)
    host = next(batch_iterator(chunks, batch_size=batch,
                               rng=np.random.RandomState(0)))
    host["ivectors"] = np.random.RandomState(3).randn(
        host["feats"].shape[0], model_cfg.ivector_dim).astype(np.float32)
    b = convert.batch_to_torch(host, dev)
    g = den_on_device(bundle, dev)
    p_dim, t_out = tree.num_pdfs, chunk_width
    print(f"B={b['feats'].shape[0]} T={t_out} P={p_dim} "
          f"S={bundle.den_arrays.num_states} blocks={list(bundle.den_arrays.shape)}",
          flush=True)
    figs = Figures(dev)

    state = init_train_state(model_cfg, trainer_cfg,
                             torch.Generator().manual_seed(0), dev)
    params, bn = state.params, state.bn_state
    p_grad = _requiring_grad(params)
    leaves = [x for _, x in tree_paths(p_grad)]

    def model_fb():
        chain, xent, _ = apply_model(model_cfg, p_grad, bn, b["feats"],
                                     b["ivectors"], train=True)
        loss = (chain.float() ** 2).sum() * 1e-6 + xent.float().sum() * 1e-9
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    figs.timed("model_fwd_bwd", "model fwd+bwd", model_fb, n=n,
               rounds=rounds)

    obs0 = torch.randn(b["feats"].shape[0], t_out, p_dim, device=dev,
                       generator=torch.Generator(dev).manual_seed(1))

    def den_fwd():
        with torch.no_grad():
            return forward_score_blocked(obs0, g, leaky_coef=0.1)

    figs.timed("den_fwd", "den fwd", den_fwd, n=n, rounds=rounds)

    def grad_of(loss_fn):
        def fn():
            o = obs0.detach().requires_grad_(True)
            return torch.autograd.grad(loss_fn(o), o)[0]
        return fn

    figs.timed("den_fwd_bwd", "den fwd+bwd", grad_of(
        lambda o: forward_score_blocked(o, g, leaky_coef=0.1).sum()),
        n=n, rounds=rounds)

    def gather_loss(o):
        mx = o.max(dim=-1, keepdim=True).values.detach()
        oe = torch.exp(torch.clamp(o - mx, min=-30.0))
        os_ = oe.index_select(-1, g.pdf_virtual)
        return (os_ * os_).sum() * 1e-6

    figs.timed("gather_fwd_bwd", "obs gather fwd+bwd", grad_of(gather_loss),
               n=n, rounds=rounds)

    step = make_train_step(model_cfg, trainer_cfg, g)
    held = [state]

    def full():
        held[0], m = step(held[0], b)
        return m

    figs.timed("full", "full step", full, n=n, rounds=rounds)
    res = figs.as_json(batch=int(b["feats"].shape[0]), chunk_width=t_out,
                       num_pdfs=int(p_dim),
                       den_states=int(bundle.den_arrays.num_states),
                       den_type=type(bundle.den_arrays).__name__)
    write_json(out_dir, "profile_den.json", res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for profile_den.json")
    ap.add_argument("--n", type=int, default=8, help="calls per round")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    run(args.out, n=args.n, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
