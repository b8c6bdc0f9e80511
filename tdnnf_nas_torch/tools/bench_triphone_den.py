"""The composed 4-gram x left-2 triphone den at the flagship's scale on
the card: its build, one den forward+grad and 30 timed train steps
(port of ``scripts/bench_triphone_den.py``).

The set-up is ``profile_den``'s production one (768 utterances, 46
phones, the 6,034-leaf left-2 tree, the 4-gram with 2,000 extra LM
states); the den's forward+grad runs at B = 64, T = 50 on observations
from ``RandomState(0)``; the train step is the flagship 7q in bf16 with
Adam (lr 1e-3 to 2e-4 over 200 steps) on the first two batches of
``RandomState(0)`` with zero i-vectors, one warm-up step, then 30 timed.

Where it differs from the reference:

- the reference reads ``den.in_pos`` and ``den.seg_bounds`` of
  ``bundle.den_arrays`` (``:59-61``) and times ``forward_score_factored``
  on it, but its ``prepare_data`` now exports a ``BlockedDenGraph``
  (``tdnnf_nas_tpu/recipes/chain_recipes.py:174``), so the script stops
  after the den build.  The port takes ``den_positions`` and
  ``den_in_degree_K`` from the composed den itself (its positions and
  its largest in-degree, what the factored export holds) and times the
  den the step uses, ``forward_score_blocked`` through the blocked-den
  kernels;
- the step's time closes with ``torch.cuda.synchronize()``, the den's
  forward+grad is the median of ``--rounds`` rounds of 20 calls (every
  round under ``rounds``), and the file (the reference's keys, plus
  ``params``, which it only prints) goes to
  ``--out DIR/triphone_bench.json``, never to ``docs/``;
- ``backend`` is the torch device type; given a set-up built already
  (``run(bundle=, tree=)``, as ``chip_smoke.py`` phase 17 passes phase
  1's), the two build times are null.

Usage: python3 -m tdnnf_nas_torch.tools.bench_triphone_den --out DIR
       [--steps N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.tools.profile_den import production_setup
from tdnnf_nas_torch.tools.timing import (Figures, device_name, sync,
                                          write_json)

# the reference's keys (scripts/bench_triphone_den.py:120-135) and params
KEYS = ("num_pdfs", "den_states", "den_positions", "den_in_degree_K",
        "phone_lm_states", "tree_build_s", "den_build_s", "den_fwd_grad_ms",
        "train_step_ms", "throughput_audio_sec_per_s", "objf_mmi", "backend",
        "batch", "chunk_width", "params")


def den_figures(bundle) -> dict:
    """The den's host figures: states, positions, the largest in-degree K
    and the phone LM's states."""
    fsa = bundle.den_fsa
    k = max(1, int(np.bincount(fsa.arc_dst, minlength=fsa.num_states).max()))
    return {"den_states": int(fsa.num_states),
            "den_positions": int(fsa.num_positions),
            "den_in_degree_K": k,
            "phone_lm_states": int(bundle.lm.num_states)}


def run(out_dir=None, num_steps: int = 30, bundle=None, tree=None,
        batch: int = 64, chunk_width: int = 50, model_overrides=(),
        rounds: int = 3, reps: int = 20, device=DEFAULT_DEVICE) -> dict:
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.models import TdnnfModelConfig, count_params
    from tdnnf_nas_torch.ops.fwdbwd import forward_score_blocked
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.train import (OptimizerConfig, TrainerConfig,
                                       init_train_state, make_train_step)

    dev = resolve_device(device)
    secs = {"tree": None, "den": None}
    if bundle is None:
        tree, bundle, secs = production_setup()
    host = den_figures(bundle)
    print(f"tree: {tree.num_pdfs} pdfs; den: S={host['den_states']} "
          f"positions={host['den_positions']} K={host['den_in_degree_K']}",
          flush=True)
    g = den_on_device(bundle, dev)
    figs = Figures(dev)
    rng = np.random.RandomState(0)
    obs = torch.from_numpy(rng.randn(batch, chunk_width, tree.num_pdfs)
                           .astype(np.float32)).to(dev)

    def den_fwd_grad():
        o = obs.detach().requires_grad_(True)
        return torch.autograd.grad(
            forward_score_blocked(o, g, 0.1).sum(), o)[0]

    den_ms = figs.timed("den_fwd_grad_ms", "den fwd+grad", den_fwd_grad,
                        n=reps, rounds=rounds, warmup=1)

    model_cfg = TdnnfModelConfig(num_pdfs=tree.num_pdfs).replace(
        **dict(model_overrides))
    trainer_cfg = TrainerConfig(optimizer=OptimizerConfig(
        kind="adam", lr_initial=1e-3, lr_final=2e-4, num_steps=200))
    chunks = bundle.egs(model_cfg, chunk_width=chunk_width,
                        max_phones_per_chunk=40)
    print(f"chunks: {len(chunks)}  egs_stats: {bundle.egs_stats}", flush=True)
    state = init_train_state(model_cfg, trainer_cfg,
                             torch.Generator().manual_seed(0), dev)
    n_params = count_params(state.params)
    print(f"params: {n_params:,}", flush=True)
    step = make_train_step(model_cfg, trainer_cfg, g)
    batches = []
    for b in batch_iterator(chunks, batch_size=batch,
                            rng=np.random.RandomState(0)):
        if len(batches) >= 2:
            break
        b["ivectors"] = np.zeros((b["feats"].shape[0], model_cfg.ivector_dim),
                                 np.float32)
        batches.append(convert.batch_to_torch(b, dev))
    state, m = step(state, batches[0])  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    for i in range(num_steps):
        state, m = step(state, batches[i % 2])
    sync(dev)
    step_ms = (time.perf_counter() - t0) / num_steps * 1e3
    audio_per_step = batch * chunk_width * 3 * 0.01
    thr = audio_per_step / (step_ms / 1e3)
    objf = float(m["objf_mmi"])
    print(f"train step: {step_ms:.1f} ms  objf_mmi={objf:.4f}  "
          f"throughput={thr:.0f} audio-sec/s", flush=True)
    out = {"num_pdfs": int(tree.num_pdfs), **host,
           "tree_build_s": (None if secs["tree"] is None
                            else round(secs["tree"], 1)),
           "den_build_s": (None if secs["den"] is None
                           else round(secs["den"], 1)),
           "den_fwd_grad_ms": round(den_ms, 2),
           "train_step_ms": round(step_ms, 1),
           "throughput_audio_sec_per_s": round(thr, 0),
           "objf_mmi": round(objf, 4), "backend": dev.type, "batch": batch,
           "chunk_width": chunk_width, "params": int(n_params),
           "steps": num_steps, "device": device_name(dev),
           "rounds": figs.rounds}
    write_json(out_dir, "triphone_bench.json", out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for triphone_bench.json")
    ap.add_argument("--steps", type=int, default=30, help="timed steps")
    args = ap.parse_args(argv)
    run(args.out, args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
