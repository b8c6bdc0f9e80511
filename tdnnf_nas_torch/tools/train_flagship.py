"""Train the flagship 7q on the synthetic SWBD-scale setup on the card
(port of ``scripts/train_flagship_synthetic.py``).

The script's settings: 128 utterances of 46 phones, the left-biphone
tree (6,034 pdfs), the bigram LM's dense den graph (through the dense-den
kernels), the flagship model, 64 x 150-frame batches with zero
i-vectors, Adam from 1e-3 to 2e-4 over the run.  Batches reach the card
through the CUDA-stream prefetcher.  Writes the objective trajectory
(every 20 steps and the last) as JSON to ``--out``; its shape compares
with ``docs/flagship_curve.json``, the reference's own run, which this
never writes.  ``--ckpt-dir`` saves the final state there, the configs
in its meta.

Usage:
    python -m tdnnf_nas_torch.tools.train_flagship [NUM_STEPS] --out PATH
        [--ckpt-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def flagship_setup(num_utts: int, min_phones: int, max_phones: int):
    """(utts, phone_seqs, topo, tree, lm, den) of the flagship synthetic
    setup with the biphone den, as the reference's two flagship scripts
    build it."""
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (BiphoneTree, build_denominator_graph,
                                        estimate_phone_lm)

    num_phones = 46
    corpus_cfg = SyntheticCorpusConfig(
        num_utts=num_utts, num_phones=num_phones, feat_dim=40,
        min_phones=min_phones, max_phones=max_phones, mean_dur=4.0, seed=0)
    utts, phone_seqs, _, topo = make_synthetic_corpus(corpus_cfg)
    tree = BiphoneTree(num_phones, num_leaves=6034 - num_phones)
    lm = estimate_phone_lm(phone_seqs, num_phones)
    den = build_denominator_graph(lm, topo, tree)
    return utts, phone_seqs, topo, tree, lm, den


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("num_steps", nargs="?", type=int, default=400)
    ap.add_argument("--out", required=True, help="trajectory JSON to write")
    ap.add_argument("--ckpt-dir", help="save the final state here")
    args = ap.parse_args(argv)

    import torch

    from tdnnf_nas_torch.core.checkpoint import save_checkpoint
    from tdnnf_nas_torch.core.config import asdict_config
    from tdnnf_nas_torch.core.device import resolve_device
    from tdnnf_nas_torch.data import EgsConfig, batch_iterator, make_egs
    from tdnnf_nas_torch.graphs import den_init_lookup
    from tdnnf_nas_torch.models import (TdnnfModelConfig, count_params,
                                        model_context)
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.parallel import prefetch_to_device
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    num_steps = args.num_steps
    utts, _, topo, tree, lm, den = flagship_setup(128, 10, 30)
    model_cfg = TdnnfModelConfig(num_pdfs=tree.num_pdfs)
    left, right = model_context(model_cfg)
    egs_cfg = EgsConfig(chunk_width=50, left_context=left,
                        right_context=right, max_phones_per_chunk=40)
    chunks = make_egs(utts, lm, topo, tree, egs_cfg,
                      den_init_fn=den_init_lookup(den, 46))
    print(f"chunks: {len(chunks)}", flush=True)
    trainer_cfg = TrainerConfig(
        objective=ChainObjectiveConfig(pallas_den=True),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=2e-4, num_steps=num_steps))
    state = init_train_state(model_cfg, trainer_cfg,
                             torch.Generator().manual_seed(0), dev)
    print(f"params: {count_params(state.params):,}", flush=True)
    step = make_train_step(model_cfg, trainer_cfg,
                           DenGraphArrays.from_graph(den, dev), seed=7)

    def with_ivectors(batches):
        for b in batches:
            b["ivectors"] = np.zeros((b["feats"].shape[0], 100), np.float32)
            yield b

    host = batch_iterator(chunks, batch_size=64,
                          rng=np.random.RandomState(0))
    it = prefetch_to_device(with_ivectors(host), size=2, device=dev)
    curve = []
    t0 = time.time()
    try:
        for i, batch in enumerate(it):
            if i >= num_steps:
                break
            state, metrics = step(state, batch)
            if i % 20 == 0 or i == num_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = time.time() - t0
                curve.append(m)
                print(f"step {i:4d} objf_mmi={m['objf_mmi']:.4f} "
                      f"xent={m.get('objf_xent', 0):.4f} "
                      f"gnorm={m['grad_norm']:.2f}", flush=True)
    finally:
        it.close()
    if not all(np.isfinite(m["objf_mmi"]) for m in curve):
        raise RuntimeError("non-finite objf_mmi in the trajectory")
    with open(args.out, "w") as f:
        json.dump(curve, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, num_steps, state, meta={
            "model": asdict_config(model_cfg),
            "trainer": asdict_config(trainer_cfg)})
        print(f"saved {path}.npz", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
