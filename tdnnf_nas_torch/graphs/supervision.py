"""Numpy copy of ``tdnnf_nas_tpu.graphs.supervision`` (numerator graphs).

Per-chunk chain numerator supervision: a linear phone graph
[enter_1, loop_1, enter_2, loop_2, ...] padded to a static state count,
plus a time-varying tolerance allow-mask [T, S] (every phone boundary may
move by up to +-tol output frames).  Transitions carry the denominator's
self-loop and phone-LM probabilities, so numerator paths are a
weight-preserving subset of denominator paths, for left-context trees
and for the +-1 tree of the committed-successor composition.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from tdnnf_nas_torch.graphs.topology import ChainTopology


@dataclasses.dataclass
class ChunkSupervision:
    """Dense per-chunk numerator graph, padded to a static state count.

    Built as numpy; batching stacks along a leading axis.  The same
    dataclass carries the batch's tensors once it is on the device
    (``convert.batch_to_torch``).
    """

    trans: np.ndarray  # [S, S] float32
    state_pdf: np.ndarray  # [S] int32
    init: np.ndarray  # [S] float32
    final: np.ndarray  # [S] float32
    mask: np.ndarray  # [T, S] float32 (1 = state allowed at frame t)
    # compact linear-chain form: next_w[i] = weight of the arc into pair
    # i+1; the numerator recursion runs in O(S) banded form on it
    next_w: np.ndarray = None  # [S//2] float32
    self_loop_prob: float = 0.5


def numerator_graph(
    phones: Sequence[int],
    lm,
    topo: ChainTopology,
    tree,
    max_states: int,
    init_ctx=None,
    init_left: tuple = (),
    next_phone: int = -1,
):
    """Linear chain graph over ``phones``, padded to max_states.

    Returns (trans, state_pdf, init, final, next_w).  ``init_ctx`` /
    ``init_left``: LM walk state and most-recent-first left phones before
    phones[0] (the true utterance context for chunks cut mid-utterance).
    ``next_phone``: the utterance's phone after the chunk's last one (-1 =
    utterance end), which a +-1 tree's last forward pdf and arc need.
    """
    n = len(phones)
    s = 2 * n
    if s > max_states:
        raise ValueError(
            f"{n} phones needs {s} states > max_states={max_states}")
    a = topo.self_loop_prob
    trans = np.zeros((max_states, max_states), dtype=np.float32)
    state_pdf = np.zeros((max_states,), dtype=np.int32)
    init = np.zeros((max_states,), dtype=np.float32)
    final = np.zeros((max_states,), dtype=np.float32)
    next_w = np.zeros((max_states // 2,), dtype=np.float32)
    ctx = lm.walk_init() if init_ctx is None else init_ctx
    left: tuple = tuple(init_left)
    tctx = getattr(tree, "context_width", 1) - 1
    rctx = getattr(tree, "right_context", 0)
    for i, p in enumerate(phones):
        e, l = 2 * i, 2 * i + 1
        _, ctx_after = lm.walk(ctx, p)
        if rctx:
            # +-1 tree: the pdf is keyed on the successor (-1 = utterance
            # end, the den's wildcard/EOS commitment)
            right = phones[i + 1] if i + 1 < n else next_phone
            state_pdf[e] = tree.forward_pdf_ctx(p, left, right=int(right))
        else:
            state_pdf[e] = tree.forward_pdf_ctx(p, left)
        state_pdf[l] = tree.self_loop_pdf(p)
        for src in (e, l):
            trans[src, l] = a
            if i + 1 < n:
                q = phones[i + 1]
                wq, ctx2 = lm.walk(ctx_after, q)
                if rctx:
                    # committed-successor semantics: the arc entering q
                    # pays q's OWN successor probability (the den's arc
                    # weight, den_graph._compile_den_fsa_committed)
                    commit = phones[i + 2] if i + 2 < n else next_phone
                    if commit == -1:
                        wq = max(lm.final_prob(ctx2), 1e-8)
                    else:
                        wq, _ = lm.walk(ctx2, int(commit))
                w = (1.0 - a) * wq
                trans[src, 2 * (i + 1)] = w
                next_w[i] = w
        ctx = ctx_after
        left = ((p,) + left)[:tctx]
    final[: s] = 1.0
    init[0] = 1.0
    return trans, state_pdf, init, final, next_w


def tolerance_mask(
    begins: Sequence[int],
    ends: Sequence[int],
    num_frames: int,
    max_states: int,
    tol: int,
) -> np.ndarray:
    """[T, S] allow-mask for the linear graph from aligned phone spans."""
    n = len(begins)
    mask = np.zeros((num_frames, max_states), dtype=np.float32)
    for i in range(n):
        b, e = int(begins[i]), int(ends[i])
        ent_lo, ent_hi = max(b - tol, 0), min(b + tol, num_frames - 1)
        loop_lo, loop_hi = max(b - tol + 1, 0), min(e + tol, num_frames - 1)
        if i == 0 and b <= 0:  # chunk starts mid-phone: allow loop from t=0
            loop_lo = 0
        mask[ent_lo: ent_hi + 1, 2 * i] = 1.0
        if loop_hi >= loop_lo:
            mask[loop_lo: loop_hi + 1, 2 * i + 1] = 1.0
    return mask


def make_chunk_supervision(
    phones: Sequence[int],
    begins: Optional[Sequence[int]],
    ends: Optional[Sequence[int]],
    lm,
    topo: ChainTopology,
    tree,
    num_frames: int,
    max_states: int,
    tol: int = 2,
    den_init_fn=None,
    den_init_seq=None,
    init_ctx=None,
    init_left: tuple = (),
    next_phone: int = -1,
) -> ChunkSupervision:
    """Full numerator supervision for one chunk.

    begins/ends None => unaligned: all states allowed at all frames.
    Numerator init weights are the den graph's initial probs restricted to
    the allowed start states (the role of Kaldi's normalization FST), taken
    from ``den_init_seq`` = (enter_init[i], loop_init[i]) of the composed
    den FSA (``CompiledDenFsa.init_lookup_seq``) or else from
    ``den_init_fn(phone, kind, left_phone)`` of a dense den graph
    (``graphs.den_graph.den_init_lookup``; kind 0 = enter, 1 = loop).
    Without either, init is uniform over the allowed start states.
    ``next_phone`` is the chunk's true successor (``numerator_graph``).
    """
    trans, state_pdf, init, final, next_w = numerator_graph(
        phones, lm, topo, tree, max_states,
        init_ctx=init_ctx, init_left=init_left, next_phone=next_phone)
    n = len(phones)
    if begins is None:
        mask = np.zeros((num_frames, max_states), dtype=np.float32)
        mask[:, : 2 * n] = 1.0
        allowed0 = np.zeros((max_states,), dtype=bool)
        allowed0[0] = True
    else:
        mask = tolerance_mask(begins, ends, num_frames, max_states, tol)
        allowed0 = mask[0] > 0
        if not allowed0.any():
            raise ValueError(
                "tolerance mask leaves no allowed state at frame 0")
    if den_init_seq is not None:
        ent, loop = den_init_seq
        init = np.zeros((max_states,), dtype=np.float32)
        for i in range(n):
            if allowed0[2 * i]:
                init[2 * i] = ent[i]
            if allowed0[2 * i + 1]:
                init[2 * i + 1] = loop[i]
    elif den_init_fn is not None:
        init = np.zeros((max_states,), dtype=np.float32)
        prev = init_left[0] if len(init_left) else -1
        for i, p in enumerate(phones):
            if allowed0[2 * i]:
                init[2 * i] = den_init_fn(p, 0, prev)
            if allowed0[2 * i + 1]:
                init[2 * i + 1] = den_init_fn(p, 1, prev)
            prev = p
    else:
        init = allowed0.astype(np.float32)
        init /= init.sum()
    return ChunkSupervision(trans=trans, state_pdf=state_pdf, init=init,
                            final=final, mask=mask, next_w=next_w,
                            self_loop_prob=topo.self_loop_prob)


def stack_supervisions(sups: Sequence[ChunkSupervision]) -> ChunkSupervision:
    """Stack per-chunk supervisions into batched arrays [B, ...].

    The dense [S, S] trans is not shipped (the numerator runs the banded
    recursion on ``next_w``): it becomes a [B, 1, 1] dummy, and the 0/1
    mask ships as uint8."""
    return ChunkSupervision(
        trans=np.zeros((len(sups), 1, 1), np.float32),
        state_pdf=np.stack([s.state_pdf for s in sups]),
        init=np.stack([s.init for s in sups]),
        final=np.stack([s.final for s in sups]),
        mask=(np.stack([s.mask for s in sups]) > 0).astype(np.uint8),
        next_w=np.stack([s.next_w for s in sups]),
        self_loop_prob=sups[0].self_loop_prob,
    )
