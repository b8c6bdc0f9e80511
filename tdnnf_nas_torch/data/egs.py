"""Numpy copy of ``tdnnf_nas_tpu.data.egs`` (training chunks).

Utterances are cut into chunks of ``chunk_width`` output frames; each
chunk's input carries the model's left/right context (edge frames
replicated at utterance boundaries, as Kaldi does), and its supervision is
a tolerance-masked numerator graph (graphs/supervision.py).  Batches are
static-shape numpy: [B, T_in, F] features plus stacked supervision.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.graphs.supervision import (
    ChunkSupervision,
    make_chunk_supervision,
    stack_supervisions,
)
from tdnnf_nas_torch.graphs.topology import ChainTopology

@dataclasses.dataclass(frozen=True)
class EgsConfig(Config):
    chunk_width: int = 50  # output frames (Kaldi 150 input = 50 subsampled)
    # extra widths for mixed-size chunks (Kaldi --egs.chunk-width 150,110,100
    # => subsampled 50,37,33, `run_tdnn_7q_fbk_40_manual.sh:186`); chunks
    # rotate through (chunk_width, *extra_chunk_widths) along each utterance
    # and batches are width-bucketed (one jit shape per width).
    extra_chunk_widths: tuple = ()
    frame_subsampling_factor: int = 3
    left_context: int = 34  # model context (models.model_context)
    right_context: int = 34
    tolerance: int = 2  # output-frame tolerance (Kaldi 5 input frames / 3)
    max_phones_per_chunk: int = 32
    min_phones_per_chunk: int = 1

    @property
    def chunk_widths(self) -> tuple:
        return (self.chunk_width,) + tuple(self.extra_chunk_widths)

    @property
    def max_states(self) -> int:
        return 2 * self.max_phones_per_chunk

    def input_frames_for(self, w: int) -> int:
        return (
            self.left_context
            + (w - 1) * self.frame_subsampling_factor
            + 1
            + self.right_context
        )


@dataclasses.dataclass
class Chunk:
    feats: np.ndarray  # [T_in, F]
    sup: ChunkSupervision
    ivector: Optional[np.ndarray] = None


def _pad_feats(feats: np.ndarray, left: int, right: int) -> np.ndarray:
    return np.concatenate(
        [np.repeat(feats[:1], left, axis=0), feats, np.repeat(feats[-1:], right, axis=0)]
    )


def make_egs(
    utts,
    lm,
    topo: ChainTopology,
    tree,
    cfg: EgsConfig,
    den_init_fn=None,
    den_fsa=None,
    stats: Optional[dict] = None,
    ivectors=None,
) -> List[Chunk]:
    """Cut utterances (data.synthetic.Utterance-like: .feats [T_in,F],
    .phones, .begins, .ends at output rate) into supervised chunks.

    ``den_fsa`` (a graphs.den_graph.CompiledDenFsa) supplies numerator init
    probs at arbitrary LM order / tree context (overrides den_init_fn);
    ``den_init_fn`` (``graphs.den_graph.den_init_lookup`` of a dense den
    graph) supplies them for the bigram den.  Without either, numerator
    init is uniform over the allowed start states.
    ``stats``, if given, is filled in-place with chunk-coverage counters —
    in particular how much supervision the max_phones_per_chunk cap drops
    (Kaldi's get_egs.sh logs the same discard accounting).
    ``ivectors``, if given, is one [D] vector per utterance attached to
    every chunk cut from it (the egs-level i-vector of get_egs.sh
    --online-ivector-dir).
    """
    fs = cfg.frame_subsampling_factor
    widths = cfg.chunk_widths
    w_min = min(widths)
    chunks: List[Chunk] = []
    n_short_utts = 0
    n_dropped_chunks = 0
    n_kept_chunks = 0
    kept_frames_total = 0
    dropped_frames = 0
    for ui, utt in enumerate(utts):
        t_out = len(utt.pdf_align) if utt.pdf_align is not None else (
            utt.feats.shape[0] // fs
        )
        padded = _pad_feats(utt.feats, cfg.left_context, cfg.right_context)
        begins = np.asarray(utt.begins)
        ends = np.asarray(utt.ends)
        if t_out < w_min:
            n_short_utts += 1
            dropped_frames += t_out
            continue  # utterance shorter than one chunk
        # per-utterance context walk: LM state + left-phone tuple BEFORE
        # each phone, and (on the composed-FSA path) den init probs along
        # the TRUE utterance path — chunks cut mid-utterance keep their
        # real context instead of resetting to BOS (Kaldi splits the
        # full-utterance supervision FST for the same reason)
        tctx = getattr(tree, "context_width", 1) - 1
        ctxs, lefts = [], []
        ctx = lm.walk_init()
        left: tuple = ()
        for p in utt.phones:
            ctxs.append(ctx)
            lefts.append(left)
            _, ctx = lm.walk(ctx, int(p))
            left = ((int(p),) + left)[:tctx]
        utt_init = (den_fsa.init_lookup_seq(lm, utt.phones)
                    if den_fsa is not None else None)
        # chunk tiling: rotate through the configured widths along the
        # utterance; last chunk snaps back to fit
        pieces = []
        pos, wi = 0, 0
        while pos + w_min <= t_out:
            w = widths[wi % len(widths)]
            wi += 1
            if pos + w > t_out:
                fits = [x for x in widths if pos + x <= t_out]
                w = max(fits) if fits else w_min
                if pos + w > t_out:
                    pos = t_out - w
            pieces.append((pos, w))
            pos += w
        if pos < t_out:
            # tail shorter than min(widths): snap a final overlapping chunk
            # back so every frame is covered (t_out >= w_min is guaranteed
            # by the short-utterance check above)
            pieces.append((t_out - w_min, w_min))
        for c, w in pieces:
            # phones overlapping [c, c+w)
            sel = (ends >= c) & (begins < c + w)
            idx = np.nonzero(sel)[0]
            if not (cfg.min_phones_per_chunk <= len(idx) <= cfg.max_phones_per_chunk):
                n_dropped_chunks += 1
                dropped_frames += w
                continue
            ph = [utt.phones[i] for i in idx]
            b = np.clip(begins[idx] - c, 0, w - 1)
            e = np.clip(ends[idx] - c, 0, w - 1)
            i0 = int(idx[0])
            den_init_seq = (
                (utt_init[0][idx], utt_init[1][idx])
                if utt_init is not None else None)
            i_last = int(idx[-1])
            nxt_ph = (int(utt.phones[i_last + 1])
                      if i_last + 1 < len(utt.phones) else -1)
            sup = make_chunk_supervision(
                ph, b.tolist(), e.tolist(), lm, topo, tree, w, cfg.max_states,
                tol=cfg.tolerance, den_init_fn=den_init_fn,
                den_init_seq=den_init_seq,
                init_ctx=ctxs[i0], init_left=lefts[i0],
                next_phone=nxt_ph,
            )
            in_start = c * fs  # padded coords: original frame c*fs - left + left
            feats = padded[in_start : in_start + cfg.input_frames_for(w)]
            chunks.append(Chunk(
                feats=feats, sup=sup,
                ivector=(np.asarray(ivectors[ui], np.float32)
                         if ivectors is not None else None)))
            n_kept_chunks += 1
            kept_frames_total += w
    if stats is not None:
        kept_frames = kept_frames_total
        stats.update(
            num_chunks=n_kept_chunks,
            dropped_chunks=n_dropped_chunks,
            short_utts=n_short_utts,
            dropped_frames=dropped_frames,
            kept_frames=kept_frames,
            dropped_fraction=(dropped_frames / max(kept_frames + dropped_frames, 1)),
        )
    return chunks


def batch_iterator(
    chunks: Sequence[Chunk],
    batch_size: int,
    rng: np.random.RandomState,
    shuffle: bool = True,
    drop_last: bool = True,
    epochs: Optional[int] = None,
) -> Iterator[dict]:
    """Yields {"feats": [B,T,F], "sup": batched ChunkSupervision,
    "ivectors": [B,D]|absent} host-side numpy batches.

    Mixed chunk widths are bucketed: every batch holds chunks of one width
    (one jit shape per width), batch order shuffled across buckets."""
    groups: dict = {}
    for j, c in enumerate(chunks):
        groups.setdefault(c.feats.shape[0], []).append(j)
    group_idx = [np.asarray(g, np.int64) for g in groups.values()]
    epoch = 0
    while epochs is None or epoch < epochs:
        batches = []
        for g in group_idx:
            order = g.copy()
            if shuffle:
                rng.shuffle(order)
            stop = len(order) - (batch_size - 1 if drop_last else 0)
            for i in range(0, max(stop, 0), batch_size):
                sel = order[i : i + batch_size]
                if drop_last and len(sel) < batch_size:
                    continue
                batches.append(sel)
        if shuffle:
            rng.shuffle(batches)
        for sel in batches:
            batch = {
                "feats": np.stack([chunks[j].feats for j in sel]),
                "sup": stack_supervisions([chunks[j].sup for j in sel]),
            }
            if chunks[sel[0]].ivector is not None:
                batch["ivectors"] = np.stack([chunks[j].ivector for j in sel])
            yield batch
        epoch += 1
