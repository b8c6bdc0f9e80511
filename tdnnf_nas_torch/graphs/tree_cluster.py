"""Numpy copy of ``tdnnf_nas_tpu.graphs.tree_cluster`` (left-2 tree build).

Likelihood-clustered phonetic-context tree, the ``build_tree.sh``
equivalent: accumulate diagonal-Gaussian sufficient statistics per seen
(phone, l1, l2) forward state from alignments, then greedily merge, within
each central phone, the pair of clusters with the smallest log-likelihood
loss until the forward-leaf budget is met.  Only the left-2 triphone path
of the slice is copied here.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import List, Optional, Sequence

import numpy as np

from tdnnf_nas_torch.graphs.topology import TriphoneTree

_VAR_FLOOR = 1e-4


@dataclasses.dataclass
class TreeStats:
    """Diagonal-Gaussian sufficient stats per (phone, left_phone) forward
    state: counts [P, P+1], sums [P, P+1, D], sumsqs [P, P+1, D]
    (left index 0 == BOS/-1)."""

    counts: np.ndarray
    sums: np.ndarray
    sumsqs: np.ndarray

    @property
    def num_phones(self) -> int:
        return self.counts.shape[0]



def _loglike(n, s, ss):
    """Optimal diagonal-Gaussian data log-likelihood of a stats cluster."""
    if n < 1e-8:
        return 0.0
    mean = s / n
    var = np.maximum(ss / n - mean * mean, _VAR_FLOOR)
    d = s.shape[-1]
    return -0.5 * n * (d * math.log(2.0 * math.pi * math.e)
                       + float(np.sum(np.log(var))))


def _cluster_contexts(
    counts: np.ndarray,  # [P, C]
    sums: np.ndarray,  # [P, C, D]
    sumsqs: np.ndarray,  # [P, C, D]
    num_leaves: int,
    min_count: float = 1.0,
    ctx_shape: Optional[tuple] = None,
):
    """Within-phone agglomerative likelihood clustering over generic context
    cells; returns (table [P*C] -> leaf id, n_leaves).  Shared by the
    biphone and triphone ("left-2") / cross (+-1) tree builders.

    UNSEEN cells (count < min_count) are assigned by hierarchical context
    backoff AFTER clustering — the count-majority leaf of the cells
    agreeing on the FIRST context coordinate (l1 row for left trees, l for
    +-1 trees; ``ctx_shape`` gives the per-coordinate grid), falling back
    to the phone's majority leaf.  This is what Kaldi's question-based
    trees do implicitly (an unseen triphone answers the same questions as
    its seen neighbors).  The previous scheme pooled unseen cells into a
    ZERO-stats cluster whose merge cost is ~0, so it merged into an
    arbitrary leaf almost immediately — measured as left-2 decode WER
    DEGRADING as the AM sharpens (wrong-word hypotheses traverse unseen
    cross-word contexts and get scored with an arbitrary leaf's output;
    the round-3 context_compare regression, VERDICT r3 weak #1)."""
    p_count, n_ctx = counts.shape
    stats = TreeStats(counts, sums, sumsqs)
    # exact agglomerative clustering is O(n^2) pairs per phone; triphone
    # grids have (P+1)^2 contexts, so pre-merge each phone's long tail of
    # low-count contexts into the nearest high-count seed (by mean
    # distance) before the exact phase — rare contexts carry little
    # likelihood, the merge loss is negligible (Kaldi bounds the same cost
    # with its question sets)
    max_initial = max(192, (3 * num_leaves) // max(p_count, 1))
    # start: one cluster per seen context (unseen cells stay -1 and are
    # backoff-assigned at the end; a phone with NO seen contexts keeps one
    # empty fallback cluster so its pdfs exist)
    cluster_of = np.full((p_count, n_ctx), -1, np.int64)
    clusters: List[Optional[dict]] = []  # {phone, n, s, ss, members}

    for p in range(p_count):
        rare = [c for c in range(n_ctx) if stats.counts[p, c] < min_count]
        seen = [c for c in range(n_ctx) if stats.counts[p, c] >= min_count]
        if not seen:
            cid = len(clusters)
            clusters.append({
                "phone": p,
                "n": float(stats.counts[p, rare].sum()),
                "s": stats.sums[p, rare].sum(axis=0),
                "ss": stats.sumsqs[p, rare].sum(axis=0),
            })
            cluster_of[p, rare] = cid
        if len(seen) > max_initial:
            seen_arr = np.asarray(seen)
            order = np.argsort(-stats.counts[p, seen_arr], kind="stable")
            seeds = seen_arr[order[:max_initial]]
            tail = seen_arr[order[max_initial:]]
            seed_means = stats.sums[p, seeds] / stats.counts[p, seeds][:, None]
            tail_means = stats.sums[p, tail] / stats.counts[p, tail][:, None]
            # nearest seed by squared Euclidean mean distance (vectorized)
            d2 = (np.sum(tail_means ** 2, -1)[:, None]
                  - 2.0 * tail_means @ seed_means.T
                  + np.sum(seed_means ** 2, -1)[None, :])
            owner = np.argmin(d2, axis=1)
            base = len(clusters)
            for k, c in enumerate(seeds):
                clusters.append({
                    "phone": p,
                    "n": float(stats.counts[p, c]),
                    "s": stats.sums[p, c].copy(),
                    "ss": stats.sumsqs[p, c].copy(),
                })
                cluster_of[p, c] = base + k
            for j, c in enumerate(tail):
                cid = base + int(owner[j])
                cl = clusters[cid]
                cl["n"] += float(stats.counts[p, c])
                cl["s"] = cl["s"] + stats.sums[p, c]
                cl["ss"] = cl["ss"] + stats.sumsqs[p, c]
                cluster_of[p, c] = cid
            continue
        for c in seen:
            cid = len(clusters)
            clusters.append({
                "phone": p,
                "n": float(stats.counts[p, c]),
                "s": stats.sums[p, c].copy(),
                "ss": stats.sumsqs[p, c].copy(),
            })
            cluster_of[p, c] = cid

    def merge_cost(a, b):
        la = _loglike(a["n"], a["s"], a["ss"])
        lb = _loglike(b["n"], b["s"], b["ss"])
        lab = _loglike(a["n"] + b["n"], a["s"] + b["s"], a["ss"] + b["ss"])
        return la + lb - lab

    # priority queue of within-phone candidate merges; entries carry the
    # version of each endpoint so costs computed against absorbed/updated
    # clusters are discarded on pop (lazy deletion + staleness check)
    alive = [True] * len(clusters)
    version = [0] * len(clusters)
    by_phone: List[List[int]] = [[] for _ in range(p_count)]
    for i, c in enumerate(clusters):
        by_phone[c["phone"]].append(i)
    heap: List[tuple] = []
    for p in range(p_count):
        ids = by_phone[p]
        for i in range(len(ids)):
            for j in range(i + 1, len(ids)):
                a, b = ids[i], ids[j]
                heapq.heappush(heap, (merge_cost(clusters[a], clusters[b]),
                                      a, b, 0, 0))

    num_alive = len(clusters)
    target = max(num_leaves, p_count)  # >= one forward leaf per phone
    while num_alive > target and heap:
        cost, a, b, va, vb = heapq.heappop(heap)
        if not (alive[a] and alive[b]) or version[a] != va or version[b] != vb:
            continue
        # merge b into a
        ca, cb = clusters[a], clusters[b]
        ca["n"] += cb["n"]
        ca["s"] = ca["s"] + cb["s"]
        ca["ss"] = ca["ss"] + cb["ss"]
        alive[b] = False
        clusters[b] = None
        version[a] += 1
        num_alive -= 1
        cluster_of[cluster_of == b] = a
        # refresh candidate merges involving a
        for o in by_phone[ca["phone"]]:
            if o != a and alive[o] and clusters[o] is not None:
                heapq.heappush(heap, (merge_cost(ca, clusters[o]),
                                      min(a, o), max(a, o),
                                      version[min(a, o)], version[max(a, o)]))

    # compact ids
    remap = {}
    for i, ok in enumerate(alive):
        if ok:
            remap[i] = len(remap)
    n_fwd = len(remap)
    fwd_table = np.full(p_count * n_ctx, -1, np.int64)
    for p in range(p_count):
        for c in range(n_ctx):
            cid = int(cluster_of[p, c])
            if cid >= 0:
                fwd_table[p * n_ctx + c] = remap[cid]

    # hierarchical backoff for unseen cells (see docstring)
    c1 = ctx_shape[0] if ctx_shape else n_ctx
    c_rest = n_ctx // c1
    tbl = fwd_table.reshape(p_count, c1, c_rest)
    cnt = counts.reshape(p_count, c1, c_rest)
    for p in range(p_count):
        # phone-majority leaf (by count mass)
        leaves_p = {}
        for i1 in range(c1):
            for i2 in range(c_rest):
                lf = tbl[p, i1, i2]
                if lf >= 0 and cnt[p, i1, i2] > 0:
                    leaves_p[lf] = leaves_p.get(lf, 0.0) + cnt[p, i1, i2]
        maj_p = (max(leaves_p, key=leaves_p.get) if leaves_p
                 else tbl[p][tbl[p] >= 0].flat[0] if (tbl[p] >= 0).any()
                 else 0)
        for i1 in range(c1):
            if (tbl[p, i1] >= 0).all():
                continue
            leaves_r = {}
            for i2 in range(c_rest):
                lf = tbl[p, i1, i2]
                if lf >= 0 and cnt[p, i1, i2] > 0:
                    leaves_r[lf] = leaves_r.get(lf, 0.0) + cnt[p, i1, i2]
            maj_r = max(leaves_r, key=leaves_r.get) if leaves_r else maj_p
            row = tbl[p, i1]
            row[row < 0] = maj_r
    return fwd_table, n_fwd


@dataclasses.dataclass
class TriphoneStats:
    """Diagonal-Gaussian sufficient stats per (phone, l1, l2) forward state
    — the two most recent left phones (index 0 == BOS/-1):
    counts [P, P+1, P+1], sums [..., D], sumsqs [..., D]."""

    counts: np.ndarray
    sums: np.ndarray
    sumsqs: np.ndarray

    @property
    def num_phones(self) -> int:
        return self.counts.shape[0]


def accumulate_triphone_stats(
    feats: Sequence[np.ndarray],
    phone_seqs: Sequence[Sequence[int]],
    begins: Sequence[Sequence[int]],
    num_phones: int,
    frame_subsampling_factor: int = 1,
) -> TriphoneStats:
    """Per-(p, l1, l2) forward-frame Gaussian stats (left-2 context window,
    see `topology.TriphoneTree` for why two LEFT phones replace the
    reference's left+right triphone window)."""
    d = feats[0].shape[-1]
    counts = np.zeros((num_phones, num_phones + 1, num_phones + 1), np.float64)
    sums = np.zeros((num_phones, num_phones + 1, num_phones + 1, d), np.float64)
    sumsqs = np.zeros_like(sums)
    for x, phones, bg in zip(feats, phone_seqs, begins):
        x = np.asarray(x, np.float64)
        l1, l2 = -1, -1
        for j, p in enumerate(phones):
            t = min(int(bg[j]) * frame_subsampling_factor, len(x) - 1)
            f = x[t]
            counts[p, l1 + 1, l2 + 1] += 1.0
            sums[p, l1 + 1, l2 + 1] += f
            sumsqs[p, l1 + 1, l2 + 1] += f * f
            l2, l1 = l1, p
    return TriphoneStats(counts, sums, sumsqs)


def build_clustered_triphone_tree(
    stats: TriphoneStats,
    num_leaves: int,
    min_count: float = 1.0,
):
    """Likelihood-clustered left-2-context tree — the `build_tree.sh` /
    tri5_7d equivalent at triphone leaf scale (the reference tree has 6034
    leaves, `run_tdnn_7q_fbk_40_manual.sh:26`)."""
    p, c1, c2 = stats.counts.shape
    d = stats.sums.shape[-1]
    table, n_fwd = _cluster_contexts(
        stats.counts.reshape(p, c1 * c2),
        stats.sums.reshape(p, c1 * c2, d),
        stats.sumsqs.reshape(p, c1 * c2, d),
        num_leaves, min_count, ctx_shape=(c1, c2))
    return TriphoneTree(p, table, n_fwd)
