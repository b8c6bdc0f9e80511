"""The port's vectorised tree clustering against the JAX package's
pure-Python lazy heap on the CPU: ``_cluster_contexts`` and the three
tree builders give the same (fwd_table, n_fwd), bit for bit, on seeded
statistics that exercise the rare-tail pre-merge (phones with more than
192 seen contexts), exact ties that decide the tree (within a phone and
across phones), a phone with no seen context, clusters whose count is
under 1e-8, float32 statistics, and the flagship's and the +-1 path's
feature dims (40 and 24); and the per-row log-likelihood equals
``_loglike`` row by row."""

import numpy as np
import pytest

from tdnnf_nas_tpu.graphs import tree_cluster as jtc
from tdnnf_nas_torch.graphs import tree_cluster as ttc


def _stats(rng, counts, d, spread=1.0, dtype=np.float64):
    """Diagonal-Gaussian sufficient statistics for cells of the given
    counts: a mean and a variance drawn per cell."""
    mean = rng.randn(*counts.shape, d) * spread
    var = rng.uniform(0.3, 2.0, counts.shape + (d,))
    sums = counts[..., None] * mean
    sumsqs = counts[..., None] * (var + mean * mean)
    return counts, sums.astype(dtype), sumsqs.astype(dtype)


def _sparse_counts(rng, p, c, seen):
    """[p, c] counts with ``seen[i]`` cells of phone i seen (geometric
    counts), a few rare cells (counts under 1) and the rest unseen."""
    counts = np.zeros((p, c))
    for i, k in enumerate(seen):
        cells = rng.permutation(c)
        counts[i, cells[:k]] = rng.geometric(0.3, k)
        counts[i, cells[k:k + 5]] = 0.5
    return counts


def _tail(d):
    # 3 phones of a 16 x 16 context grid; phones 0 and 1 see more than
    # 192 contexts, so their long tails are pre-merged into seeds
    rng = np.random.RandomState(11)
    counts = _sparse_counts(rng, 3, 256, (230, 210, 60))
    assert (counts >= 1).sum(1).max() > max(192, 3 * 150 // 3)
    return _stats(rng, counts, d), 150, 1.0, (16, 16)


def _ties(d):
    # exact ties that decide the tree: in each phone, cells B and their
    # twins B' (B's dims swapped in adjacent pairs) beside cells A that the
    # swap leaves as they are, so that cost(A, B) == cost(A, B') bit for
    # bit (numpy's pairwise sum of a row of 24 or 40 adds each adjacent
    # pair of its 8 running sums before anything else) while B and B'
    # differ; ids decide.  Phone 2 repeats phone 0, so ties also run
    # across phones.
    rng = np.random.RandomState(12)
    swap = np.arange(d).reshape(-1, 2)[:, ::-1].ravel()
    n_a, n_b, c = 4, 10, 48
    counts, sums, sumsqs = (np.zeros((4, c)), np.zeros((4, c, d)),
                            np.zeros((4, c, d)))
    for p in range(4):
        cells = rng.permutation(c)[:n_a + 2 * n_b]
        n = rng.randint(1, 6, n_a + n_b).astype(np.float64)
        mean = rng.randn(n_a + n_b, d)
        var = rng.uniform(0.3, 2.0, (n_a + n_b, d))
        mean[:n_a] = mean[:n_a, swap[::2]].repeat(2, 1)
        var[:n_a] = var[:n_a, swap[::2]].repeat(2, 1)
        s, sq = n[:, None] * mean, n[:, None] * (var + mean * mean)
        counts[p, cells] = np.concatenate([n, n[n_a:]])
        sums[p, cells] = np.concatenate([s, s[n_a:, swap]])
        sumsqs[p, cells] = np.concatenate([sq, sq[n_a:, swap]])
    counts[2], sums[2], sumsqs[2] = counts[0], sums[0], sumsqs[0]
    return (counts, sums, sumsqs), 40, 1.0, (6, 8)


def _empty(d):
    # phone 1 sees no context (its rare cells pool into one fallback
    # cluster), phone 3 has no count at all, and with a tiny min_count
    # phone 0 holds seen cells of count under 1e-8 (log-likelihood 0)
    rng = np.random.RandomState(13)
    counts = _sparse_counts(rng, 5, 30, (20, 0, 18, 0, 25))
    counts[3] = 0.0
    counts[0, :6] = 5e-9
    return _stats(rng, counts, d), 12, 1e-9, (5, 6)


def _float32(d):
    # float32 sums and sumsqs: the reference divides them by a Python
    # float in float32
    rng = np.random.RandomState(14)
    counts = _sparse_counts(rng, 4, 40, (30, 25, 35, 12))
    return _stats(rng, counts, d, dtype=np.float32), 30, 1.0, None


CASES = {"tail": _tail, "ties": _ties, "empty": _empty, "float32": _float32}


@pytest.mark.parametrize("d", [40, 24])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_contexts_equal(case, d):
    (counts, sums, sumsqs), leaves, min_count, ctx_shape = CASES[case](d)
    jt, jn = jtc._cluster_contexts(counts, sums, sumsqs, leaves, min_count,
                                   ctx_shape=ctx_shape)
    tt, tn = ttc._cluster_contexts(counts, sums, sumsqs, leaves, min_count,
                                   ctx_shape=ctx_shape)
    assert tn == jn
    assert tt.dtype == jt.dtype
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("builder,d", [
    ("build_clustered_tree", 24),
    ("build_clustered_triphone_tree", 40),
    ("build_clustered_cross_triphone_tree", 24)])
def test_builders_equal(builder, d):
    """Each builder on seeded statistics of its context grid (8 phones),
    leaves cut so that most contexts merge."""
    rng = np.random.RandomState(15)
    if builder == "build_clustered_tree":
        counts = _sparse_counts(rng, 8, 9, (9, 7, 8, 2, 9, 5, 0, 9))
        cls = (jtc.TreeStats, ttc.TreeStats)
    else:
        counts = _sparse_counts(rng, 8, 81, (70, 40, 55, 3, 64, 20, 0, 81)
                                ).reshape(8, 9, 9)
        cls = (jtc.TriphoneStats, ttc.TriphoneStats)
    st = _stats(rng, counts, d)
    jtree = getattr(jtc, builder)(cls[0](*st), num_leaves=60)
    ttree = getattr(ttc, builder)(cls[1](*st), num_leaves=60)
    assert type(ttree).__name__ == type(jtree).__name__
    assert ttree._n_fwd == jtree._n_fwd
    assert ttree.num_pdfs == jtree.num_pdfs
    np.testing.assert_array_equal(ttree._fwd_table, jtree._fwd_table)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d", [1, 7, 8, 9, 24, 40, 128, 129, 300])
def test_loglike_rows_equal_loglike(d, dtype):
    """The per-row log-likelihood equals the reference's ``_loglike`` of
    each row, bit for bit, across the pairwise sum's regimes (under 8
    terms, unrolled by 8, blocks of 128), floored variances, and counts
    at and under 1e-8."""
    rng = np.random.RandomState(d)
    n = rng.geometric(0.05, 64).astype(np.float64)
    n[:4] = (0.0, 5e-9, 1e-8, 1.5)
    _, s, ss = _stats(rng, n, d, dtype=dtype)
    ss[4] = (s[4] * s[4] / n[4]).astype(dtype)  # variance floored
    got = ttc._loglike_rows(n, s, ss)
    want = [jtc._loglike(float(n[k]), s[k], ss[k]) for k in range(len(n))]
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))
