"""Numpy copy of ``tdnnf_nas_tpu.nas.search``: schedules and architecture
extraction for the two-stage DARTS pipeline.

  * temperature annealing (`temperature_schedule.py:34-67`): tau goes
    linearly from t_max to t_min over the fraction of data processed;
  * extraction (`generate_top_list.py:50-67`,
    `generate_top_list_bottleneckdim.py`): beam search (beam 10) over the
    product of per-component softmax(alpha) for the top-K architectures,
    then the child configs;
  * analytic parameter counting
    (`bottleneckdim_search_top_model_size.py:68-76`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from tdnnf_nas_torch.models.tdnnf import TdnnfModelConfig


def temperature_at(data_fraction: float, t_max: float = 1.0, t_min: float = 0.03) -> float:
    """Linear anneal tau: f=0 -> t_max, f=1 -> t_min."""
    f = min(max(data_fraction, 0.0), 1.0)
    return (1.0 - f) * (t_max - t_min) + t_min


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))


def beam_search_archs(
    logits: np.ndarray, beam: int = 10, top_k: int = 10
) -> List[Tuple[Tuple[int, ...], float]]:
    """Top-K index tuples maximizing sum_c log softmax(logits[c])[i_c].

    logits: [num_components, K].  Returns [(indices, total_logprob)] sorted
    best-first.  Matches the reference's beam search over the product of
    per-component probabilities (`generate_top_list.py:50-67`, beam 10).
    """
    logp = _log_softmax(np.asarray(logits, np.float64))
    hyps: List[Tuple[Tuple[int, ...], float]] = [((), 0.0)]
    for c in range(logp.shape[0]):
        nxt = [
            (idx + (i,), lp + logp[c, i])
            for idx, lp in hyps
            for i in range(logp.shape[1])
        ]
        nxt.sort(key=lambda h: -h[1])
        hyps = nxt[: max(beam, top_k)]
    return hyps[:top_k]


def extract_offsets(
    alpha_linear: np.ndarray, alpha_affine: np.ndarray, beam: int = 10, top_k: int = 5
) -> List[Tuple[Tuple[Tuple[int, int], ...], float]]:
    """Searched (linear_stride, affine_stride) per layer, best-first.

    alpha_*: [L, K] logits; candidate index == |offset| for both sublayers
    (linear candidates -(K-1)..0 stored reversed, see models/nas.py).
    Interleaves the 2L components as the reference does (odd = linear,
    even = affine, `generate_top_list.py:19-28`).
    """
    l = alpha_linear.shape[0]
    inter = np.stack([alpha_linear, alpha_affine], axis=1).reshape(2 * l, -1)
    archs = beam_search_archs(inter, beam=beam, top_k=top_k)
    out = []
    for idx, lp in archs:
        pairs = tuple((int(idx[2 * i]), int(idx[2 * i + 1])) for i in range(l))
        out.append((pairs, lp))
    return out


def extract_bottlenecks(
    alpha_bottleneck: np.ndarray,
    candidates: Sequence[int],
    beam: int = 10,
    top_k: int = 5,
) -> List[Tuple[Tuple[int, ...], float]]:
    """Searched bottleneck dim per layer, best-first."""
    archs = beam_search_archs(np.asarray(alpha_bottleneck), beam=beam, top_k=top_k)
    cands = list(candidates)
    return [(tuple(cands[i] for i in idx), lp) for idx, lp in archs]


def child_config_from_arch(
    base: TdnnfModelConfig,
    stride_pairs: Tuple[Tuple[int, int], ...] = (),
    bottleneck_dims: Tuple[int, ...] = (),
) -> TdnnfModelConfig:
    """Child (retrain) model config from a searched architecture.

    Equivalent of the reference child-config rewriting
    (`generate_top_list.py:95-143`, `generate_top_list_bottleneckdim.py:
    72-106`): the child is a plain TDNN-F with the searched offsets and/or
    per-layer bottleneck dims.
    """
    kw = {}
    if stride_pairs:
        kw["time_strides_asym"] = tuple(stride_pairs)
    if bottleneck_dims:
        kw["bottleneck_dims"] = tuple(bottleneck_dims)
    return base.replace(**kw)


def arch_param_count(cfg: TdnnfModelConfig) -> int:
    """Analytic parameter count of a child model (cf.
    `bottleneckdim_search_top_model_size.py:68-76`)."""
    n = 0
    n += cfg.lda_dim * cfg.lda_dim + cfg.lda_dim
    n += cfg.lda_dim * cfg.hidden_dim + cfg.hidden_dim
    for i, (l, r) in enumerate(cfg.stride_pairs):
        b = cfg.layer_bottleneck(i)
        n += (2 if l > 0 else 1) * cfg.hidden_dim * b
        n += (2 if r > 0 else 1) * b * cfg.hidden_dim + cfg.hidden_dim
    n += cfg.hidden_dim * cfg.prefinal_small
    for _ in range(2):
        n += cfg.prefinal_small * cfg.prefinal_big + cfg.prefinal_big
        n += cfg.prefinal_big * cfg.prefinal_small
        n += cfg.prefinal_small * cfg.num_pdfs + cfg.num_pdfs
    return n
