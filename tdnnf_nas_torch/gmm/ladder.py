"""Port of ``tdnnf_nas_tpu.gmm.ladder``: the GMM bootstrap ladder, mono ->
tri -> LDA+MLLT -> SAT (fMLLR) -> alignments (`run.sh:139-257`, then
`Prepare_NAS_data.sh:66-75`'s final fMLLR alignment pass).

Output: per-utterance phone begin/end frames at the subsampled output
rate, for the tolerance-window chain supervision.  The features live on
the device (the card by default) as one tensor per utterance; splicing,
the LDA/MLLT/fMLLR projections, every forced alignment (batched over
utterances) and the EM statistics run there, the small solves and the
bookkeeping on the host (``gmm.py``, ``transforms.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.gmm.gmm import (AmGmm, MonoHmmConfig, _linear_hmm_arrays,
                                     align_utterances, as_tensor, f64,
                                     path_to_phone_bounds, train_mono,
                                     train_tri)
from tdnnf_nas_torch.gmm.transforms import (apply_fmllr, estimate_fmllr,
                                            estimate_lda, estimate_mllt,
                                            splice_utterances)


@dataclasses.dataclass(frozen=True)
class GmmLadderConfig(Config):
    mono: MonoHmmConfig = MonoHmmConfig()
    # context-dependent tied-state budget (0 = skip the tri1/tri2 stages)
    tri_leaves: int = 0
    tri_em_iters: int = 8
    tri_min_count: float = 3.0
    splice_context: int = 3
    lda_dim: int = 0  # 0 => keep the input feature dim
    mllt_iters: int = 6
    lda_mllt_em_iters: int = 8
    sat_em_iters: int = 6
    fmllr_iters: int = 5
    frame_subsampling_factor: int = 3
    # EM-stage training subset (0 = every utterance), stratified
    # round-robin over speakers; the full set is aligned at the end
    train_subset: int = 0


@dataclasses.dataclass
class GmmLadderResult:
    am: AmGmm
    transform: np.ndarray  # [D', spliced_D] LDA+MLLT feature transform
    fmllr: dict  # speaker -> [D', D'+1]
    begins: List[List[int]]  # per utt, OUTPUT-rate phone begins
    ends: List[List[int]]
    mono_ll: List[float]
    mllt_aux: List[float]
    fmllr_gain: float  # mean per-frame loglike gain from fMLLR


def _state_classes(am: AmGmm, phone_seqs, paths) -> List[np.ndarray]:
    """Per-frame am-state ids from chain paths (LDA/MLLT classes)."""
    out = []
    for phones, path in zip(phone_seqs, paths):
        ids = _linear_hmm_arrays(phones, am)
        out.append(ids[path].astype(np.int64))
    return out


def _frame_gaussians(am: AmGmm, feats: torch.Tensor, state_ids: np.ndarray):
    """Each frame hard-assigned to the best mixture of its aligned state:
    ([F, D] means, [F, D] inverse variances) for the fMLLR statistics."""
    s = torch.as_tensor(state_ids, device=am.device)
    comp = torch.argmax(am.own_state_loglike(feats, s), dim=1)
    return am.means[s, comp], 1.0 / am.variances[s, comp]


def _project(feats_list, mat: np.ndarray) -> List[torch.Tensor]:
    """x @ mat.T for every utterance, as one product (float64)."""
    x = torch.cat(list(feats_list))
    m = torch.as_tensor(mat, device=x.device)
    return list(torch.split(f64(x) @ m.T,
                            [f.shape[0] for f in feats_list]))


def run_gmm_ladder(
    feats_list: Sequence,  # INPUT-rate features per utt
    phone_seqs: Sequence[Sequence[int]],
    num_phones: int,
    cfg: GmmLadderConfig = GmmLadderConfig(),
    speakers: Optional[Sequence] = None,  # per-utt speaker id (None = one)
    device=DEFAULT_DEVICE,
) -> GmmLadderResult:
    dev = resolve_device(device)
    feats_list = [as_tensor(f, dev) for f in feats_list]
    n = len(feats_list)
    speakers = list(speakers) if speakers is not None else [0] * n
    d_in = feats_list[0].shape[1]

    # EM-stage training subset: round-robin over speakers so every speaker
    # has fMLLR statistics
    if cfg.train_subset and cfg.train_subset < n:
        by_spk: dict = {}
        for i in range(n):
            by_spk.setdefault(speakers[i], []).append(i)
        sub: List[int] = []
        queues = list(by_spk.values())
        r = 0
        while len(sub) < cfg.train_subset:
            q = queues[r % len(queues)]
            if q:
                sub.append(q.pop(0))
            r += 1
        sub.sort()
    else:
        sub = list(range(n))
    sub_feats = [feats_list[i] for i in sub]
    sub_phones = [phone_seqs[i] for i in sub]

    # ---- stage 1: monophone flat-start EM -------------------------------
    am, paths, mono_ll = train_mono(sub_feats, sub_phones, num_phones,
                                    cfg.mono, device=dev)

    # ---- stage 1.5: context-dependent tied-state GMM (tri1/tri2) --------
    if cfg.tri_leaves > 0:
        am, paths, _ = train_tri(
            sub_feats, sub_phones, num_phones,
            dataclasses.replace(cfg.mono, num_iters=cfg.tri_em_iters),
            am, cfg.tri_leaves, min_count=cfg.tri_min_count,
        )

    # ---- stage 2: LDA + MLLT on spliced features (tri3) -----------------
    spliced = splice_utterances(feats_list, cfg.splice_context)
    sub_spliced = [spliced[i] for i in sub]
    classes = _state_classes(am, sub_phones, paths)
    num_classes = am.num_states
    lda_dim = cfg.lda_dim or d_in
    lda = estimate_lda(sub_spliced, classes, num_classes, lda_dim)
    lda_feats = _project(sub_spliced, lda)
    mllt, mllt_aux = estimate_mllt(lda_feats, classes, num_classes,
                                   cfg.mllt_iters)
    transform = mllt @ lda  # [lda_dim, spliced_D]
    tr_feats = _project(spliced, transform)
    sub_tr = [tr_feats[i] for i in sub]
    # retrain in the transformed space, re-tying the context tree there
    am2, paths, _ = train_mono(
        sub_tr, sub_phones, num_phones,
        dataclasses.replace(cfg.mono, num_iters=cfg.lda_mllt_em_iters),
        device=dev)
    if cfg.tri_leaves > 0:
        am2, paths, _ = train_tri(
            sub_tr, sub_phones, num_phones,
            dataclasses.replace(cfg.mono, num_iters=cfg.tri_em_iters),
            am2, cfg.tri_leaves, min_count=cfg.tri_min_count,
        )

    # ---- stage 3: SAT / per-speaker fMLLR (tri4) ------------------------
    spk_ids = sorted(set(speakers))
    classes = _state_classes(am2, sub_phones, paths)
    mus, ivs = _frame_gaussians(am2, torch.cat(sub_tr),
                                np.concatenate(classes))
    lens = [f.shape[0] for f in sub_tr]
    mus, ivs = torch.split(mus, lens), torch.split(ivs, lens)
    sub_of = {u: j for j, u in enumerate(sub)}
    fmllr = {}
    for spk in spk_ids:
        idx = [i for i in sub if speakers[i] == spk]
        if not idx:  # speaker absent from the subset: identity transform
            d = tr_feats[0].shape[1]
            fmllr[spk] = np.concatenate(
                [np.eye(d), np.zeros((d, 1))], axis=1)
            continue
        fmllr[spk] = estimate_fmllr(
            [tr_feats[i] for i in idx], [mus[sub_of[i]] for i in idx],
            [ivs[sub_of[i]] for i in idx], cfg.fmllr_iters)
    adapted: List[Optional[torch.Tensor]] = [None] * n
    for spk in spk_ids:
        idx = [i for i in range(n) if speakers[i] == spk]
        if idx:
            out = apply_fmllr(torch.cat([tr_feats[i] for i in idx]),
                              fmllr[spk])
            for i, a in zip(idx, torch.split(
                    out, [tr_feats[i].shape[0] for i in idx])):
                adapted[i] = a
    # retrain on adapted features (SAT), warm-started from am2
    am3, _, _ = train_mono(
        [adapted[i] for i in sub], sub_phones, num_phones,
        dataclasses.replace(cfg.mono, num_iters=cfg.sat_em_iters),
        init_am=am2,
    )
    # fMLLR-gain diagnostic on the training subset
    _, s0 = align_utterances(sub_tr, sub_phones, am2)
    _, s1 = align_utterances([adapted[i] for i in sub], sub_phones, am3)
    base_ll, adapt_ll, frames = 0.0, 0.0, 0
    for j, i in enumerate(sub):
        base_ll += s0[j]
        adapt_ll += s1[j]
        frames += tr_feats[i].shape[0]
    # final alignment pass over the FULL corpus with the SAT model
    paths, _ = align_utterances(adapted, list(phone_seqs), am3)

    # ---- alignments at the output frame rate ----------------------------
    fs = cfg.frame_subsampling_factor
    begins_out, ends_out = [], []
    for i in range(n):
        b, e = path_to_phone_bounds(paths[i], phone_seqs[i],
                                    am3.states_per_phone)
        t_out = max(1, feats_list[i].shape[0] // fs)
        bb = [min(x // fs, t_out - 1) for x in b]
        ee = [min(x // fs, t_out - 1) for x in e]
        # keep begins strictly usable: end >= begin per phone
        ee = [max(be, en) for be, en in zip(bb, ee)]
        begins_out.append(bb)
        ends_out.append(ee)

    return GmmLadderResult(
        am=am3, transform=transform, fmllr=fmllr,
        begins=begins_out, ends=ends_out,
        mono_ll=mono_ll, mllt_aux=mllt_aux,
        fmllr_gain=(adapt_ll - base_ll) / max(frames, 1),
    )
