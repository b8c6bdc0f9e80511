"""The port's GMM ladder (``tdnnf_nas_torch.gmm``) against the JAX
package's numpy ladder (``tdnnf_nas_tpu.gmm``), in float64 on the CPU.

Both run on the same seeded synthetic corpus.  The port computes its frame
statistics as batched products and segment sums (another summation order
than the reference's per-utterance loops), so continuous results agree to
float64 rounding, held at 1e-10 relative for log-likelihoods, 1e-9 for the
EM trajectory and 1e-8 for the transforms; hard decisions (alignments,
tying, begins and ends) are held equal.
"""

import numpy as np
import pytest
import torch

import tdnnf_nas_tpu.gmm as jgmm
from tdnnf_nas_tpu.data.synthetic import (SyntheticCorpusConfig,
                                          make_synthetic_corpus)
from tdnnf_nas_tpu.gmm import gmm as jg
from tdnnf_nas_tpu.gmm import transforms as jt
from tdnnf_nas_tpu.recipes.chain_recipes import (
    bootstrap_alignments_gmm as j_bootstrap)

import tdnnf_nas_torch.gmm as tgmm
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.gmm import gmm as tg
from tdnnf_nas_torch.gmm import transforms as tt
from tdnnf_nas_torch.recipes.chain_recipes import (
    bootstrap_alignments_gmm as t_bootstrap)

torch.set_num_threads(2)
P = 6


@pytest.fixture(scope="module")
def corpus():
    cfg = SyntheticCorpusConfig(num_utts=24, num_phones=P, feat_dim=10,
                                mean_dur=4.0, emission_noise=0.6, seed=3)
    utts, phone_seqs, _, _ = make_synthetic_corpus(cfg)
    return utts, phone_seqs


def _mono_cfg(mod, **kw):
    base = dict(num_iters=5, max_mix=2, mix_up_iters=(2,))
    base.update(kw)
    return mod.MonoHmmConfig(**base)


@pytest.fixture(scope="module")
def mono(corpus):
    """Both packages' monophone models trained on the corpus."""
    utts, phone_seqs = corpus
    feats = [u.feats for u in utts]
    jm = jg.train_mono(feats, phone_seqs, P, _mono_cfg(jg))
    tm = tg.train_mono(feats, phone_seqs, P, _mono_cfg(tg), device="cpu")
    return jm, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


def test_component_loglike_and_loglikes(corpus, mono):
    """DiagGmm.component_loglike of float32 and float64 frames and
    AmGmm.loglikes, on the reference's model converted to the port."""
    utts, _ = corpus
    jam = mono[0][0]
    tam = convert.am_gmm_from_jax(jam, "cpu")
    for x in (utts[0].feats, utts[1].feats.astype(np.float64)):
        xt = torch.tensor(x)
        for s in (0, 7, 16):
            assert _rel(jam.gmms[s].component_loglike(x),
                        tam.gmms[s].component_loglike(xt)) <= 1e-10
        assert _rel(jam.loglikes(x), tam.loglikes(xt)) <= 1e-10


def test_mono_training_trajectory(mono):
    """train_mono: per-iteration log-likelihood within 1e-9 relative, the
    same final alignments and mixtures."""
    (jam, jp, jll), (tam, tp, tll) = mono
    assert _rel(jll, tll) <= 1e-9
    assert all(np.array_equal(a, b) for a, b in zip(jp, tp))
    assert list(tam.num_mix) == [g.num_mix for g in jam.gmms]
    for gj, gt in zip(jam.gmms, tam.gmms):
        assert _rel(gj.means, gt.means) <= 1e-9
        assert _rel(gj.variances, gt.variances) <= 1e-9
        assert _rel(gj.weights, gt.weights) <= 1e-9


def test_viterbi_align_and_batched(corpus, mono):
    """viterbi_align_gmm: the same path and score as the reference; the
    batched alignment of all utterances (two groups under a small
    budget) equals the per-utterance one."""
    utts, phone_seqs = corpus
    jam = mono[0][0]
    tam = convert.am_gmm_from_jax(jam, "cpu")
    feats = [torch.tensor(u.feats) for u in utts]
    for i in (0, 5):
        pj, sj = jg.viterbi_align_gmm(utts[i].feats, phone_seqs[i], jam)
        pt, st = tg.viterbi_align_gmm(feats[i], phone_seqs[i], tam)
        assert np.array_equal(pj, pt) and pt.dtype == np.int32
        assert abs(sj - st) <= 1e-10 * abs(sj)
    one = [tg.viterbi_align_gmm(f, p, tam) for f, p in zip(feats,
                                                           phone_seqs)]
    budget = tg._ALIGN_BUDGET
    try:
        tg._ALIGN_BUDGET = 12 * 150 * 60
        paths, scores = tg.align_utterances(feats, phone_seqs, tam)
    finally:
        tg._ALIGN_BUDGET = budget
    for (p1, s1), p2, s2 in zip(one, paths, scores):
        assert np.array_equal(p1, p2) and s1 == s2
    assert abs(jg.corpus_loglike(jam, [u.feats for u in utts], phone_seqs)
               - tg.corpus_loglike(tam, feats, phone_seqs)) <= 1e-9


def test_split_matches_reference(mono):
    jam = mono[0][0]
    tam = convert.am_gmm_from_jax(jam, "cpu").split(4)
    for gj, gt in zip(jam.gmms, tam.gmms):
        s = gj.split(4)
        assert np.array_equal(s.weights, gt.weights.numpy())
        assert np.array_equal(s.means, gt.means.numpy())
        assert np.array_equal(s.variances, gt.variances.numpy())


def test_train_tri_from_reference_model(corpus, mono):
    """train_tri started from the reference's monophone model: the same
    tie table and per-iteration log-likelihood."""
    utts, phone_seqs = corpus
    feats = [u.feats for u in utts]
    jam = mono[0][0]
    cfgj = _mono_cfg(jg, num_iters=3, mix_up_iters=(1,))
    cfgt = _mono_cfg(tg, num_iters=3, mix_up_iters=(1,))
    j2, jp, jll = jg.train_tri(feats, phone_seqs, P, cfgj, jam, 10)
    t2, tp, tll = tg.train_tri(feats, phone_seqs, P, cfgt,
                               convert.am_gmm_from_jax(jam, "cpu"), 10)
    assert np.array_equal(j2.tie_table, t2.tie_table)
    assert t2.num_states == len(j2.gmms)
    assert _rel(jll, tll) <= 1e-9
    assert all(np.array_equal(a, b) for a, b in zip(jp, tp))


@pytest.fixture(scope="module")
def classes(corpus, mono):
    utts, phone_seqs = corpus
    jam, jp, _ = mono[0]
    ids = [jg._linear_hmm_arrays(p, jam)[path].astype(np.int64)
           for p, path in zip(phone_seqs, jp)]
    spliced = [jt.splice_frames(u.feats, 2) for u in utts]
    return ids, spliced, len(jam.gmms)


def test_splice_lda_mllt(corpus, classes):
    """splice_frames equal; LDA on float64 frames within 1e-8 relative
    (on float32 frames the raw scatter is a float32 product, as numpy's,
    summed in another order: 1e-5); MLLT and its aux trajectory within
    1e-8."""
    utts, _ = corpus
    ids, spliced, k = classes
    sp_t = tt.splice_utterances([torch.tensor(u.feats) for u in utts], 2)
    for a, b in zip(spliced, sp_t):
        assert np.array_equal(a, b.numpy())
    assert np.array_equal(jt.splice_frames(utts[0].feats, 1),
                          tt.splice_frames(utts[0].feats, 1,
                                           device="cpu").numpy())
    x64 = [x.astype(np.float64) for x in spliced]
    lj = jt.estimate_lda(x64, ids, k, 12)
    lt = tt.estimate_lda(x64, ids, k, 12, device="cpu")
    assert _rel(lj, lt) <= 1e-8
    assert _rel(jt.estimate_lda(spliced, ids, k, 12),
                tt.estimate_lda(spliced, ids, k, 12, device="cpu")) <= 1e-5
    feats = [x @ lj.T for x in x64]
    mj, aj = jt.estimate_mllt(feats, ids, k, 4)
    mt, at = tt.estimate_mllt(feats, ids, k, 4, device="cpu")
    assert _rel(mj, mt) <= 1e-8
    assert _rel(aj, at) <= 1e-8


def test_fmllr_and_auxf(corpus, mono):
    """fMLLR of an affinely corrupted speaker within 1e-8 relative, its
    auxiliary objective within 1e-10, apply_fmllr equal to 1e-12."""
    utts, phone_seqs = corpus
    jam, jp, _ = mono[0]
    rng = np.random.RandomState(0)
    a = np.eye(10) + 0.1 * rng.randn(10, 10)
    b = rng.randn(10)
    xs = [u.feats.astype(np.float64) @ a.T + b for u in utts[:6]]
    mus, ivs = [], []
    for u, path, p in zip(utts[:6], jp[:6], phone_seqs[:6]):
        st = jg._linear_hmm_arrays(p, jam)[path]
        mus.append(np.stack([jam.gmms[s].means[0] for s in st]))
        ivs.append(np.stack([1.0 / jam.gmms[s].variances[0] for s in st]))
    wj = jt.estimate_fmllr(xs, mus, ivs, 4)
    wt = tt.estimate_fmllr(xs, mus, ivs, 4, device="cpu")
    assert _rel(wj, wt) <= 1e-8
    assert abs(jt.fmllr_auxf(xs, mus, ivs, wj)
               - tt.fmllr_auxf(xs, mus, ivs, wj, device="cpu")) <= 1e-10 * \
        abs(jt.fmllr_auxf(xs, mus, ivs, wj))
    assert _rel(jt.apply_fmllr(xs[0], wj),
                tt.apply_fmllr(xs[0], wj, device="cpu").numpy()) <= 1e-12


def _ladder_cfg(mod):
    return mod.GmmLadderConfig(
        mono=_mono_cfg(mod, num_iters=4), tri_leaves=10, tri_em_iters=3,
        splice_context=2, lda_dim=8, mllt_iters=3, lda_mllt_em_iters=3,
        sat_em_iters=2, fmllr_iters=3, train_subset=15)


def test_run_gmm_ladder_matches(corpus):
    """The whole ladder with tied triphones and a 15-utterance training
    subset: begins and ends equal, transforms within 1e-8 relative, the
    diagnostics within 1e-9."""
    utts, phone_seqs = corpus
    feats = [u.feats for u in utts]
    spk = [i % 3 for i in range(len(utts))]
    rj = jgmm.run_gmm_ladder(feats, phone_seqs, P, _ladder_cfg(jgmm),
                             speakers=spk)
    rt = tgmm.run_gmm_ladder(feats, phone_seqs, P, _ladder_cfg(tgmm),
                             speakers=spk, device="cpu")
    assert rt.begins == rj.begins and rt.ends == rj.ends
    assert _rel(rj.transform, rt.transform) <= 1e-8
    assert sorted(rt.fmllr) == sorted(rj.fmllr)
    for s in rj.fmllr:
        assert _rel(rj.fmllr[s], rt.fmllr[s]) <= 1e-8
    assert _rel(rj.mono_ll, rt.mono_ll) <= 1e-9
    assert _rel(rj.mllt_aux, rt.mllt_aux) <= 1e-9
    assert abs(rj.fmllr_gain - rt.fmllr_gain) <= 1e-9 * abs(rj.fmllr_gain)
    conv = convert.ladder_result_from_jax(rj, "cpu")
    assert conv.begins == rt.begins
    x = torch.tensor(np.random.RandomState(1).randn(20, 8))
    assert _rel(conv.am.loglikes(x), rt.am.loglikes(x)) <= 1e-8


def test_bootstrap_alignments_gmm(corpus):
    """The recipe writes the ladder's begins and ends into the utterances,
    as the reference's does."""
    utts, phone_seqs = corpus
    import copy
    uj, ut = copy.deepcopy(utts[:12]), copy.deepcopy(utts[:12])
    cfgj = jgmm.GmmLadderConfig(mono=_mono_cfg(jgmm, num_iters=3),
                                lda_dim=8, mllt_iters=2,
                                lda_mllt_em_iters=2, sat_em_iters=2,
                                fmllr_iters=2)
    cfgt = tgmm.GmmLadderConfig(mono=_mono_cfg(tgmm, num_iters=3),
                                lda_dim=8, mllt_iters=2,
                                lda_mllt_em_iters=2, sat_em_iters=2,
                                fmllr_iters=2)
    _, rj = j_bootstrap(uj, phone_seqs[:12], P, ladder_cfg=cfgj)
    _, rt = t_bootstrap(ut, phone_seqs[:12], P, ladder_cfg=cfgt,
                        device="cpu")
    assert [u.begins for u in ut] == [u.begins for u in uj] == rt.begins
    assert [u.ends for u in ut] == [u.ends for u in uj]
