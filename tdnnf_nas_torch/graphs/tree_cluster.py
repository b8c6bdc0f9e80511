"""Numpy counterpart of ``tdnnf_nas_tpu.graphs.tree_cluster`` (tree builds).

Likelihood-clustered phonetic-context trees, the ``build_tree.sh``
equivalent: accumulate diagonal-Gaussian sufficient statistics per seen
forward state from alignments, then greedily merge, within each central
phone, the pair of clusters with the smallest log-likelihood loss until
the forward-leaf budget is met.  Three context windows share the
clustering: the biphone (l, p), the left-2 triphone (l2, l1, p) and the
+-1 triphone (l, p, r) of the reference's ``tri5_7d`` tree.

The statistics and ``_loglike`` are the reference's; the clustering is
vectorised, not a line-for-line copy of the reference's lazy heap: the
clusters' statistics and log-likelihoods live in arrays, each phone's
merge costs in a matrix filled in one pass and refreshed one row at a
time, with the reference's float operations in its order and its pop
order, ties included.  ``tests/test_torch_tree_cluster.py`` holds its
tables equal to the reference's bit for bit (rare-tail pre-merge, exact
ties, empty phones, float32 statistics), beside the trees of
``tests/test_torch_cross_triphone.py`` and the drivers' tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from tdnnf_nas_torch.graphs.topology import (BiphoneTree, CrossTriphoneTree,
                                             TriphoneTree)

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


def accumulate_tree_stats(
    feats: Sequence[np.ndarray],
    phone_seqs: Sequence[Sequence[int]],
    begins: Sequence[Sequence[int]],
    num_phones: int,
    frame_subsampling_factor: int = 1,
) -> TreeStats:
    """Per-biphone forward-frame Gaussian stats from alignments: feats[i]
    [T, D] at the input rate, begins[i] the output-rate phone starts; each
    phone contributes the feature frame at its start."""
    d = feats[0].shape[-1]
    counts = np.zeros((num_phones, num_phones + 1), np.float64)
    sums = np.zeros((num_phones, num_phones + 1, d), np.float64)
    sumsqs = np.zeros((num_phones, num_phones + 1, d), np.float64)
    for x, phones, bg in zip(feats, phone_seqs, begins):
        x = np.asarray(x, np.float64)
        left = -1
        for j, p in enumerate(phones):
            t = min(int(bg[j]) * frame_subsampling_factor, len(x) - 1)
            f = x[t]
            counts[p, left + 1] += 1.0
            sums[p, left + 1] += f
            sumsqs[p, left + 1] += f * f
            left = p
    return TreeStats(counts, sums, sumsqs)


def _loglike(n, s, ss):
    """Optimal diagonal-Gaussian data log-likelihood of a stats cluster."""
    if n < 1e-8:
        return 0.0
    mean = s / n
    var = np.maximum(ss / n - mean * mean, _VAR_FLOOR)
    d = s.shape[-1]
    return -0.5 * n * (d * math.log(2.0 * math.pi * math.e)
                       + float(np.sum(np.log(var))))


def _loglike_rows(n, s, ss):
    """``_loglike`` of each row of n [K], s [K, D], ss [K, D], bit for bit:
    the same float operations in the same order (a Python float divides
    an array in the array's type; numpy sums each row of a C-contiguous
    array pairwise exactly as it sums a 1-D vector)."""
    d = s.shape[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = s / n.astype(np.result_type(s.dtype, 1.0))[:, None]
        var = np.maximum(
            ss / n.astype(np.result_type(ss.dtype, 1.0))[:, None]
            - mean * mean, _VAR_FLOOR)
        tot = np.log(var).sum(axis=-1).astype(np.float64)
    out = -0.5 * n * (d * math.log(2.0 * math.pi * math.e) + tot)
    out[n < 1e-8] = 0.0
    return out


class ClusteredBiphoneTree(BiphoneTree):
    """BiphoneTree whose forward-pdf table came from likelihood clustering."""

    def __init__(self, num_phones: int, fwd_table: np.ndarray, n_fwd: int):
        self.num_phones = num_phones
        self.context_width = 2
        self._fwd_table = np.asarray(fwd_table, np.int64)
        self._n_fwd = int(n_fwd)
        self.num_pdfs = self._n_fwd + num_phones


def build_clustered_tree(
    stats: TreeStats,
    num_leaves: int,
    min_count: float = 1.0,
) -> ClusteredBiphoneTree:
    """Agglomerative likelihood clustering of biphone forward states;
    num_leaves caps the FORWARD pdf count (plus one self-loop pdf per
    phone)."""
    fwd_table, n_fwd = _cluster_contexts(
        stats.counts, stats.sums, stats.sumsqs, num_leaves, min_count)
    return ClusteredBiphoneTree(stats.num_phones, fwd_table, n_fwd)


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

    if not clusters:
        return np.full(0, -1, np.int64), 0
    # cluster statistics as arrays in id order, each cluster's
    # log-likelihood computed once when it is made or grows; a phone's
    # ids are one range (the loop above appends phone by phone)
    phone = np.asarray([c["phone"] for c in clusters], np.int64)
    n = np.asarray([c["n"] for c in clusters], np.float64)
    s = np.stack([c["s"] for c in clusters])
    ss = np.stack([c["ss"] for c in clusters])
    ll = _loglike_rows(n, s, ss)
    first = np.searchsorted(phone, np.arange(p_count + 1))
    alive = np.ones(len(clusters), bool)
    parent = np.arange(len(clusters))

    def merge_costs(a, b):
        """``la + lb - lab`` of clusters a and b, elementwise over ids."""
        lab = _loglike_rows(n[a] + n[b], s[a] + s[b], ss[a] + ss[b])
        return (ll[a] + ll[b]) - lab

    # cost[p][i, j] (i < j, both alive) is the merge cost of the phone's
    # local clusters i and j, +inf elsewhere.  Every live pair has one
    # current cost, so the next merge is the least (cost, min id, max id)
    # over all phones: the pop order of a lazy heap of those tuples, exact
    # ties included (argmin takes the first minimum in row-major order,
    # the least (i, j); ``min`` over the phones' bests breaks ties by id)
    cost = []
    for p in range(p_count):
        m = np.full((first[p + 1] - first[p],) * 2, np.inf)
        i, j = np.triu_indices(len(m), 1)
        for k in range(0, len(i), 1 << 15):  # 32k pairs a pass
            ik, jk = i[k:k + (1 << 15)], j[k:k + (1 << 15)]
            m[ik, jk] = merge_costs(first[p] + ik, first[p] + jk)
        cost.append(m)

    def phone_best(p):
        m = cost[p]
        if np.count_nonzero(alive[first[p]:first[p + 1]]) < 2:
            return None
        k = int(np.argmin(m))
        i, j = divmod(k, m.shape[0])
        return float(m.flat[k]), int(first[p]) + i, int(first[p]) + j

    best = [phone_best(p) for p in range(p_count)]
    num_alive = len(clusters)
    target = max(num_leaves, p_count)  # >= one forward leaf per phone
    while num_alive > target:
        cands = [t for t in best if t is not None]
        if not cands:
            break
        _, a, b = min(cands)
        # merge b into a
        p = int(phone[a])
        n[a] = n[a] + n[b]
        s[a] = s[a] + s[b]
        ss[a] = ss[a] + ss[b]
        ll[a] = _loglike_rows(n[a:a + 1], s[a:a + 1], ss[a:a + 1])[0]
        alive[b] = False
        parent[b] = a
        num_alive -= 1
        # refresh the pairs of a, drop those of b
        m, base = cost[p], first[p]
        m[b - base, :] = np.inf
        m[:, b - base] = np.inf
        others = np.flatnonzero(alive[base:first[p + 1]]) + base
        others = others[others != a]
        c = merge_costs(a, others)
        lo = others < a
        m[others[lo] - base, a - base] = c[lo]
        m[a - base, others[~lo] - base] = c[~lo]
        best[p] = phone_best(p)

    # every cell of an absorbed cluster goes to the cluster that absorbed
    # it, and on to whatever absorbed that one
    while True:
        up = parent[parent]
        if np.array_equal(up, parent):
            break
        parent = up
    cluster_of = np.where(cluster_of >= 0, parent[cluster_of], -1)

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


def accumulate_cross_triphone_stats(
    feats: Sequence[np.ndarray],
    phone_seqs: Sequence[Sequence[int]],
    begins: Sequence[Sequence[int]],
    num_phones: int,
    frame_subsampling_factor: int = 1,
) -> TriphoneStats:
    """Per-(p, l, r) forward-frame Gaussian stats, the +-1 triphone window
    (index 0 == BOS/EOS/-1 in either slot), in the TriphoneStats container
    (axis 1 = left, axis 2 = right)."""
    d = feats[0].shape[-1]
    counts = np.zeros((num_phones, num_phones + 1, num_phones + 1), np.float64)
    sums = np.zeros((num_phones, num_phones + 1, num_phones + 1, d), np.float64)
    sumsqs = np.zeros_like(sums)
    for x, phones, bg in zip(feats, phone_seqs, begins):
        x = np.asarray(x, np.float64)
        n = len(phones)
        for j, p in enumerate(phones):
            t = min(int(bg[j]) * frame_subsampling_factor, len(x) - 1)
            f = x[t]
            l = phones[j - 1] if j > 0 else -1
            r = phones[j + 1] if j + 1 < n else -1
            counts[p, l + 1, r + 1] += 1.0
            sums[p, l + 1, r + 1] += f
            sumsqs[p, l + 1, r + 1] += f * f
    return TriphoneStats(counts, sums, sumsqs)


def build_clustered_cross_triphone_tree(
    stats: TriphoneStats,
    num_leaves: int,
    min_count: float = 1.0,
) -> CrossTriphoneTree:
    """Likelihood-clustered +-1 triphone tree (stats from
    ``accumulate_cross_triphone_stats``)."""
    p, c1, c2 = stats.counts.shape
    d = stats.sums.shape[-1]
    table, n_fwd = _cluster_contexts(
        stats.counts.reshape(p, c1 * c2),
        stats.sums.reshape(p, c1 * c2, d),
        stats.sumsqs.reshape(p, c1 * c2, d),
        num_leaves, min_count, ctx_shape=(c1, c2))
    return CrossTriphoneTree(p, table, n_fwd)


def build_tree_from_corpus(
    utts,
    phone_seqs: Sequence[Sequence[int]],
    num_phones: int,
    num_leaves: int,
    frame_subsampling_factor: int = 1,
    min_count: float = 1.0,
) -> ClusteredBiphoneTree:
    """One-call biphone tree build from aligned utterances (the
    ``build_tree.sh`` equivalent)."""
    stats = accumulate_tree_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        num_phones, frame_subsampling_factor,
    )
    return build_clustered_tree(stats, num_leaves, min_count=min_count)
