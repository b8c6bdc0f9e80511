"""The flagship-scale DARTS offsets search on the card, in two runs that
hand over through a checkpoint (port of
``scripts/search_flagship_synthetic.py``).

The script's settings: 96 utterances of 14-34 phones, the left-biphone
tree (6,034 pdfs) and the bigram dense den, the offsets supernet (K = 7
branches x 14 layers, no i-vectors), batches of 32 with 50 output frames.
Stage A: uniform one-hot pretrain of theta (Adam 1e-3 to 3e-4), then the
state is saved to ``--ckpt-dir`` with the configs in its meta.  Stage B
loads it, restarts the step count (as the script does), runs the gumbel
alpha-only cv-update with theta and BN frozen (Adam 1e-2 to 3e-3) and
extracts the top 3 archs.  Each stage writes its JSON to ``--out``
(stage B: the alphas, the top archs and the final objf, as the script
writes to ``docs/flagship_search.json``, which this never touches).

Usage:
    python -m tdnnf_nas_torch.tools.search_flagship A --ckpt-dir DIR
        --out PATH [--pretrain-steps N]
    python -m tdnnf_nas_torch.tools.search_flagship B --ckpt-dir DIR
        --out PATH [--cv-steps N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=("A", "B"))
    ap.add_argument("--ckpt-dir", required=True,
                    help="stage A saves its state here, stage B loads it")
    ap.add_argument("--out", required=True, help="JSON to write")
    ap.add_argument("--pretrain-steps", type=int, default=200)
    ap.add_argument("--cv-steps", type=int, default=60)
    args = ap.parse_args(argv)

    import torch

    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.core.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from tdnnf_nas_torch.core.config import asdict_config
    from tdnnf_nas_torch.core.device import resolve_device
    from tdnnf_nas_torch.data import EgsConfig, batch_iterator, make_egs
    from tdnnf_nas_torch.graphs import den_init_lookup
    from tdnnf_nas_torch.models import (DartsModelConfig, SearchMode,
                                        TdnnfModelConfig, count_params,
                                        supernet_context)
    from tdnnf_nas_torch.nas import extract_offsets
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.parallel import prefetch_to_device
    from tdnnf_nas_torch.tools.train_flagship import flagship_setup
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    utts, _, topo, tree, lm, den = flagship_setup(96, 14, 34)
    den_arr = DenGraphArrays.from_graph(den, dev)
    base = TdnnfModelConfig(num_pdfs=tree.num_pdfs, ivector_dim=0)
    darts_cfg = DartsModelConfig(base=base, search_offsets=True, max_stride=6)
    left, right = supernet_context(darts_cfg)
    egs_cfg = EgsConfig(chunk_width=50, left_context=left,
                        right_context=right, max_phones_per_chunk=44)
    chunks = make_egs(utts, lm, topo, tree, egs_cfg,
                      den_init_fn=den_init_lookup(den, 46))
    print(f"chunks: {len(chunks)} context: ({left},{right})", flush=True)

    pre_cfg = TrainerConfig(
        objective=ChainObjectiveConfig(pallas_den=True),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=3e-4,
                                  num_steps=args.pretrain_steps),
        search_mode=SearchMode.UNIFORM)
    state = init_train_state(darts_cfg, pre_cfg,
                             torch.Generator().manual_seed(0), dev,
                             supernet=True)
    print(f"supernet params: {count_params(state.params):,}", flush=True)

    def run(step, state, n, seed, label):
        """n steps on batches of 32 shuffled by RandomState(seed)."""
        host = batch_iterator(chunks, batch_size=32,
                              rng=np.random.RandomState(seed))
        it = prefetch_to_device(host, size=2, device=dev)
        objfs, m, t0 = [], None, time.time()
        try:
            for i, b in enumerate(it):
                if i >= n:
                    break
                state, m = step(state, b)
                if i % 10 == 0:
                    objfs.append([i, float(m["objf_mmi"])])
                    print(f"[{label}] step {i} objf={objfs[-1][1]:.4f} "
                          f"tau={float(m['tau']):.3f} "
                          f"({time.time() - t0:.0f}s)", flush=True)
        finally:
            it.close()
        final = float(m["objf_mmi"])
        if not np.isfinite(final) or not all(np.isfinite(o)
                                             for _, o in objfs):
            raise RuntimeError(f"{label}: non-finite objf_mmi")
        return state, objfs, final, (time.time() - t0) / n

    meta = {"model": asdict_config(darts_cfg),
            "trainer": asdict_config(pre_cfg), "supernet": True}
    if args.stage == "A":
        step = make_train_step(darts_cfg, pre_cfg, den_arr, seed=3,
                               supernet=True)
        state, objfs, final, dt = run(step, state, args.pretrain_steps, 0,
                                      "pretrain")
        path = save_checkpoint(args.ckpt_dir, args.pretrain_steps, state,
                               meta)
        out = {"stage": "A", "objf": objfs, "final_objf": final,
               "s_per_step": dt, "checkpoint": path + ".npz"}
        print(f"stage A done; checkpoint {path}.npz", flush=True)
    else:
        state, ck_step, ck_meta = load_checkpoint(args.ckpt_dir, state)
        if ck_meta.get("model") != meta["model"]:
            raise ValueError("the checkpoint holds another supernet config")
        print(f"loaded the stage A checkpoint of step {ck_step} (state step "
              f"{state.step})", flush=True)
        cv_cfg = TrainerConfig(
            objective=ChainObjectiveConfig(pallas_den=True),
            optimizer=OptimizerConfig(kind="adam", lr_initial=1e-2,
                                      lr_final=3e-3, num_steps=args.cv_steps,
                                      alpha_lr_scale=1.0),
            search_mode=SearchMode.GUMBEL, train_theta=False,
            train_alpha=True, bn_frozen=True)
        state = dataclasses.replace(state, step=0)
        step = make_train_step(darts_cfg, cv_cfg, den_arr, seed=3,
                               supernet=True)
        state, objfs, final, dt = run(step, state, args.cv_steps, 1,
                                      "cvupdate")
        alphas = convert.tree_to_numpy(state.alphas)
        archs = extract_offsets(alphas["offsets_linear"],
                                alphas["offsets_affine"], top_k=3)
        out = {"alpha_linear": alphas["offsets_linear"].tolist(),
               "alpha_affine": alphas["offsets_affine"].tolist(),
               "top_archs": [[list(map(list, a)), lp] for a, lp in archs],
               "final_objf": final, "objf": objfs, "s_per_step": dt,
               "loaded_step": ck_step}
        print("top arch:", archs[0][0], flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
