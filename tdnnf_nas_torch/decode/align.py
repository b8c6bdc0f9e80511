"""Port of ``tdnnf_nas_tpu.decode.align``: forced alignment, Viterbi over
the numerator (transcript) graph.

The replacement for the reference's GMM-HMM alignment bootstrap
(`run.sh` mono->tri4 + fMLLR aligns, `Prepare_NAS_data.sh:66-75`): train a
flat-start chain model with unaligned numerator supervision, then
force-align with it to produce the phone begin/end frames that the
tolerance-window supervision of the main training stage consumes.  The
model's forward and the Viterbi run on ``device`` (the card unless the
caller asks for the CPU); the numerator graph is built on the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.convert import tree_to_device
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.egs import _pad_feats
from tdnnf_nas_torch.decode.viterbi import log_weights, viterbi_decode
from tdnnf_nas_torch.graphs.supervision import numerator_graph
from tdnnf_nas_torch.graphs.topology import ChainTopology
from tdnnf_nas_torch.models.tdnnf import apply_model, model_context


def align_utterance(
    obs_logprob,  # [T_out, P] chain log-output of ONE utterance (array/tensor)
    phones: Sequence[int],
    lm,
    topo: ChainTopology,
    tree,
    device=DEFAULT_DEVICE,
) -> Tuple[List[int], List[int], float]:
    """Returns (begins, ends, score) at the output frame rate."""
    dev = resolve_device(device)
    n = len(phones)
    trans, state_pdf, init, final, _ = numerator_graph(phones, lm, topo, tree,
                                                       2 * n)
    # force completion: final mass only on the LAST phone's states
    final = np.zeros_like(final)
    final[2 * n - 2:] = 1.0
    lt, li, lf = (torch.from_numpy(a).to(dev)
                  for a in log_weights(trans, init, final))
    score, paths = viterbi_decode(
        torch.as_tensor(obs_logprob, dtype=torch.float32, device=dev)[None],
        lt, torch.tensor(state_pdf.astype(np.int64), device=dev), li, lf)
    path = paths[0].cpu().numpy()
    begins = [-1] * n
    ends = [0] * n
    for t, s in enumerate(path):
        i = int(s) // 2
        if begins[i] < 0:
            begins[i] = t
        ends[i] = t
    # states are visited in order; fill any (impossible) gaps defensively
    for i in range(n):
        if begins[i] < 0:
            begins[i] = ends[i - 1] + 1 if i > 0 else 0
            ends[i] = max(ends[i], begins[i])
    return begins, ends, float(score[0])


def align_corpus(bundle, model_cfg, state, utts, ivectors=None,
                 device=DEFAULT_DEVICE) -> list:
    """Force-align utterances with a trained model; returns new Utterance
    objects with refreshed begins/ends (for the aligned training stage).

    ``ivectors``: per-utterance [D] vectors for a model that takes them
    (zeros if omitted, as ``forward_corpus`` does; the reference passes
    none, so it aligns only i-vector-free models).  ``state``'s params
    are copied to ``device`` if they live elsewhere.
    """
    dev = resolve_device(device)
    params = tree_to_device(state.params, dev)
    bn_state = tree_to_device(state.bn_state, dev)
    left, right = model_context(model_cfg)
    out = []
    with torch.inference_mode():
        for i, utt in enumerate(utts):
            t_out = len(utt.pdf_align)
            need = (left + (t_out - 1) * model_cfg.frame_subsampling_factor
                    + 1 + right)
            feats = _pad_feats(utt.feats, left, right + 2)[None, :need]
            iv = None
            if model_cfg.ivector_dim:
                iv = (np.zeros((1, model_cfg.ivector_dim), np.float32)
                      if ivectors is None
                      else np.asarray(ivectors[i], np.float32)[None])
                iv = torch.tensor(iv, device=dev)
            chain, _, _ = apply_model(model_cfg, params, bn_state,
                                      torch.tensor(feats, device=dev), iv,
                                      train=False)
            begins, ends, _ = align_utterance(chain[0], utt.phones, bundle.lm,
                                              bundle.topo, bundle.tree,
                                              device=dev)
            out.append(dataclasses.replace(utt, begins=begins, ends=ends))
    return out
