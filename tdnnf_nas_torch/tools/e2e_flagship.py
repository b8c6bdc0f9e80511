"""Stages of ``scripts/e2e_flagship.py`` on the port.

``bootstrap_stage`` is its stages 1-2 (:143-167 there): the GMM ladder
on the card aligns the training utterances, then a likelihood-clustered
tree is built from those alignments: the left-2 triphone tree the
reference's flagship uses, or the +-1 triphone tree of its ``tri5_7d``
recipe.  ``chip_smoke.py`` phase 10 drives the +-1 path.

``lhuc_adapt_and_decode`` is its stage 7 (:468-560 there): per-speaker
LHUC enrollment and the adapted decode.

For each test speaker, up to 10 of the speaker's training utterances
are cut into 50-frame chunks and up to 8 batches of 16; 24 SGD steps
(lr 0.2) train the LHUC logits of the frozen model through the chain
objective (``models/lhuc.adapt_lhuc``; against a blocked den each step
launches the blocked forward and adjoint kernels once); then the
speaker's test utterances are decoded with the adapted scales through
``decode/beam.beam_decode_sparse``.  The reference adapts supervised, on
the speaker's training utterances.  ``chip_smoke.py`` phase 9 drives it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.egs import EgsConfig, batch_iterator, make_egs
from tdnnf_nas_torch.decode.beam import beam_decode_sparse
from tdnnf_nas_torch.decode.scoring import score_corpus
from tdnnf_nas_torch.graphs.tree_cluster import (
    accumulate_cross_triphone_stats, accumulate_triphone_stats,
    build_clustered_cross_triphone_tree, build_clustered_triphone_tree)
from tdnnf_nas_torch.models.lhuc import adapt_lhuc, apply_model_lhuc
from tdnnf_nas_torch.models.tdnnf import model_context
from tdnnf_nas_torch.recipes.chain_recipes import (bootstrap_alignments_gmm,
                                                   den_on_device)

# the reference's enrollment batch and batch cap (scripts/e2e_flagship.py:517-528)
LHUC_BATCH = 16
LHUC_MAX_BATCHES = 8


TREE_KINDS = {
    # the reference flagship's left-2 tree, and the +-1 tree of tri5_7d
    "left2": (accumulate_triphone_stats, build_clustered_triphone_tree),
    "pm1": (accumulate_cross_triphone_stats,
            build_clustered_cross_triphone_tree),
}


def bootstrap_stage(train, train_phones, num_phones: int, ladder_cfg,
                    num_leaves: int, tree_kind: str = "left2",
                    speakers=None, frame_subsampling_factor: int = 3,
                    device=DEFAULT_DEVICE):
    """E2e stages 1-2: the GMM ladder on ``device`` replaces the training
    utterances' begins and ends (``bootstrap_alignments_gmm``), then the
    ``tree_kind`` tree ("left2" or "pm1") of ``num_leaves`` forward leaves
    is clustered on the host from the new alignments.  Returns (tree,
    ladder result, {"gmm": s, "tree": s})."""
    if tree_kind not in TREE_KINDS:
        raise ValueError(f"tree_kind must be one of {sorted(TREE_KINDS)}, "
                         f"got {tree_kind!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    _, ladder = bootstrap_alignments_gmm(
        train, train_phones, num_phones,
        speakers=speakers, ladder_cfg=ladder_cfg, device=dev)
    t_gmm = time.perf_counter() - t0
    accumulate, build = TREE_KINDS[tree_kind]
    t0 = time.perf_counter()
    stats = accumulate([u.feats for u in train], train_phones,
                       [u.begins for u in train], num_phones,
                       frame_subsampling_factor)
    tree = build(stats, num_leaves=num_leaves)
    return tree, ladder, {"gmm": t_gmm, "tree": time.perf_counter() - t0}


def lhuc_batches(chunks):
    """Host batches of one speaker's chunks, as the reference takes them:
    ``batch_iterator`` shuffled by ``RandomState(0)`` without dropping
    the last, at most ``LHUC_MAX_BATCHES``.  A short batch is padded to
    ``LHUC_BATCH`` by repeating its first chunk.  The reference does so
    for one jit shape, but the repeated chunk also enters the loss and
    its gradient a second time, so the port keeps it to compute the same
    objective.  No chunks raise ValueError (the reference's endless
    ``batch_iterator`` would never yield)."""
    if not chunks:
        raise ValueError("no chunks to adapt on")
    out = []
    for b in batch_iterator(chunks, LHUC_BATCH, np.random.RandomState(0),
                            drop_last=False):
        n_b = b["feats"].shape[0]
        if n_b < LHUC_BATCH:
            b = convert.map_batch(lambda _, a: np.concatenate(
                [a, np.repeat(a[:1], LHUC_BATCH - n_b, 0)]), b)
        out.append(b)
        if len(out) >= LHUC_MAX_BATCHES:
            break
    return out


def lhuc_adapt_and_decode(bundle, topo, tree, g, test, refs, iv_test,
                          objective_cfg, mc_l, state_l, use_iv: bool,
                          base_hyps, num_steps: int = 24, lr: float = 0.2,
                          l2: float = 0.0, on_step=None,
                          device=DEFAULT_DEVICE) -> dict:
    """Per-speaker LHUC enrollment and the adapted decode of the speakers'
    test utterances; returns {"speakers", "utts", "wer_before",
    "wer_after"} over the decoded utterances (``base_hyps``: their
    unadapted hypotheses) and "max_abs_logit", each speaker's largest
    adapted |logit| (0 would mean LHUC left the model as it was).  ``on_step(metrics)`` sees every LHUC step's
    metrics.  ``l2`` decays the logits toward unit scales."""
    dev = resolve_device(device)
    t0 = time.time()
    left, right = model_context(mc_l)
    fs = mc_l.frame_subsampling_factor
    params = convert.tree_to_device(state_l.params, dev)
    bn_state = convert.tree_to_device(state_l.bn_state, dev)
    den = den_on_device(bundle, dev)
    spk_train = {}
    for i, u in enumerate(bundle.train_utts):
        spk_train.setdefault(u.speaker, []).append(i)
    hyps_l = [None] * len(test)
    max_abs_logit = []
    # one decode length for the stage: every utterance padded to the test
    # set's longest output, rounded up to 64, with repeated edge frames
    t_max = max(len(u.pdf_align) for u in test)
    t_pad_all = ((t_max + 63) // 64) * 64
    need = left + (t_pad_all - 1) * fs + 1 + right
    egs_cfg = EgsConfig(chunk_width=50, left_context=left,
                        right_context=right, max_phones_per_chunk=40)
    speakers = [s for s in sorted({u.speaker for u in test})
                if spk_train.get(s)]
    for spk in speakers:
        idx = spk_train[spk][:10]
        sutts = [bundle.train_utts[i] for i in idx]
        sivs = [bundle.train_ivectors[i] for i in idx] if use_iv else None
        chunks = make_egs(sutts, bundle.lm, topo, tree, egs_cfg,
                          den_fsa=bundle.den_fsa, ivectors=sivs)
        batches = [convert.batch_to_torch(b, dev)
                   for b in lhuc_batches(chunks)]
        lhuc, _ = adapt_lhuc(mc_l, params, bn_state, den, objective_cfg,
                             batches, num_steps=num_steps, lr=lr, l2=l2,
                             on_step=on_step, device=dev)
        max_abs_logit.append(max(float(v.abs().max())
                                 for v in lhuc.values()))
        for i, u in enumerate(test):
            if u.speaker != spk:
                continue
            feats = np.concatenate([
                np.repeat(u.feats[:1], left, 0), u.feats,
                np.repeat(u.feats[-1:], need, 0)])[None, :need]
            iv = (torch.as_tensor(np.asarray(iv_test[i], np.float32)[None],
                                  device=dev) if use_iv else None)
            with torch.inference_mode():
                chain, _, _ = apply_model_lhuc(
                    mc_l, params, bn_state, lhuc,
                    torch.as_tensor(feats, device=dev), iv, train=False)
            obs = chain[0].float().cpu().numpy()
            hyps_l[i] = beam_decode_sparse(
                obs[: len(u.pdf_align)], g, beam=16.0, max_active=10000,
                retry_beam=64.0).words
    done = [i for i, h in enumerate(hyps_l) if h is not None]
    wer_after = score_corpus([refs[i] for i in done],
                             [hyps_l[i] for i in done])["wer"]
    wer_before = score_corpus([refs[i] for i in done],
                              [base_hyps[i] for i in done])["wer"]
    print(f"[lhuc] iv={use_iv} l2={l2} steps={num_steps} ({len(speakers)} "
          f"speakers, {len(done)} utts): WER {wer_before:.2f} -> "
          f"{wer_after:.2f} ({time.time() - t0:.0f}s)", flush=True)
    return {"speakers": len(speakers), "utts": len(done),
            "wer_before": wer_before, "wer_after": wer_after,
            "max_abs_logit": max_abs_logit}
