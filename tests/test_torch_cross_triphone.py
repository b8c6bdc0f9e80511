"""The +-1 (tri5_7d-shaped) tree path of the port against the JAX package
on the CPU: cross-triphone statistics and the clustered tree, the biphone
clustering, the committed-successor den composition and its blocked
export with the wildcard term, the +-1 numerator and its chunks, the
plain blocked scan and the kernels' emulated arithmetic on that export,
three float32 training steps, the sparse HCLG of a +-1 tree, and the e2e
bootstrap stage."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import graphs as jgraphs
from tdnnf_nas_tpu.data import synthetic as jsyn
from tdnnf_nas_tpu.decode import graph_sparse as jgs
from tdnnf_nas_tpu.decode import wfst as jwfst
from tdnnf_nas_tpu.lm import ngram as jng
from tdnnf_nas_tpu.ops import fwdbwd as jfwd
from tdnnf_nas_torch import convert
from tdnnf_nas_torch import graphs as tgraphs
from tdnnf_nas_torch.data import synthetic as tsyn
from tdnnf_nas_torch.decode import graph_sparse as tgs
from tdnnf_nas_torch.decode import wfst as twfst
from tdnnf_nas_torch.graphs import supervision as tsup
from tdnnf_nas_torch.lm import ngram as tng
from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
from tdnnf_nas_torch.ops import fwdbwd as tfwd

torch.set_num_threads(1)
P = 6
_BLOCKED = ("w_blocks", "perm", "perm_inv", "init_pos", "pdf_virtual",
            "init_virtual", "final_virtual", "bcast_sel", "bcast_vec")
_FSA = ("seg_bounds", "state_pdf", "arc_dst", "arc_src_pos", "arc_w", "init",
        "final")


def _corpus(num=60, seed=0):
    """tests/test_cross_triphone.py's corpus."""
    rng = np.random.RandomState(seed)
    seqs = [list(rng.randint(0, P, rng.randint(4, 12))) for _ in range(num)]
    feats = [rng.randn(len(s) * 3, 8).astype(np.float32) for s in seqs]
    begins = [list(range(len(s))) for s in seqs]
    return seqs, feats, begins


@pytest.fixture(scope="module")
def pair():
    """Both packages' cross-triphone stats, 30-leaf trees, LMs (bigram and
    4-gram) and committed dens."""
    seqs, feats, begins = _corpus()
    out = {"seqs": seqs}
    for name, g in (("j", jgraphs), ("t", tgraphs)):
        stats = g.accumulate_cross_triphone_stats(feats, seqs, begins, P, 1)
        tree = g.build_clustered_cross_triphone_tree(stats, num_leaves=30)
        lms = {"bigram": g.estimate_phone_lm(seqs, P),
               "4gram": g.estimate_ngram_phone_lm(
                   seqs, P, order=4, num_extra_lm_states=20)}
        fsas = {k: g.compile_denominator_fsa(lm, g.ChainTopology(P), tree)
                for k, lm in lms.items()}
        out[name] = dict(stats=stats, tree=tree, lms=lms, fsas=fsas)
    return out


def test_cross_stats_and_tree_equal(pair):
    j, t = pair["j"], pair["t"]
    for f in ("counts", "sums", "sumsqs"):
        np.testing.assert_array_equal(getattr(t["stats"], f),
                                      getattr(j["stats"], f), err_msg=f)
    assert t["tree"].right_context == j["tree"].right_context == 1
    assert t["tree"].num_pdfs == j["tree"].num_pdfs
    np.testing.assert_array_equal(t["tree"]._fwd_table, j["tree"]._fwd_table)
    for l, p, r in ((-1, 0, -1), (2, 3, 4), (5, 1, -1)):
        assert (t["tree"].forward_pdf_ctx(p, (l,), right=r)
                == j["tree"].forward_pdf_ctx(p, (l,), right=r)
                == j["tree"].forward_pdf_lr(p, l, r))
        assert t["tree"].self_loop_pdf(p) == j["tree"].self_loop_pdf(p)


def test_biphone_clustering_equal():
    """accumulate_tree_stats, build_clustered_tree, build_tree_from_corpus."""
    seqs, feats, begins = _corpus(40, seed=3)
    js = jgraphs.accumulate_tree_stats(feats, seqs, begins, P, 1)
    ts = tgraphs.accumulate_tree_stats(feats, seqs, begins, P, 1)
    for f in ("counts", "sums", "sumsqs"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    jt = jgraphs.build_clustered_tree(js, num_leaves=12)
    tt = tgraphs.build_clustered_tree(ts, num_leaves=12)
    np.testing.assert_array_equal(tt._fwd_table, jt._fwd_table)
    assert tt.num_pdfs == jt.num_pdfs
    assert all(tt.forward_pdf(p, l) == jt.forward_pdf(p, l)
               for p in range(P) for l in range(-1, P))

    class U:
        def __init__(self, f, b):
            self.feats, self.begins = f, b

    utts = [U(f, b) for f, b in zip(feats, begins)]
    jc = jgraphs.build_tree_from_corpus(utts, seqs, P, 12)
    tc = tgraphs.build_tree_from_corpus(utts, seqs, P, 12)
    np.testing.assert_array_equal(tc._fwd_table, jc._fwd_table)


@pytest.mark.parametrize("lm", ["bigram", "4gram"])
def test_committed_den_equal(pair, lm):
    """Every CompiledDenFsa array and walk dict, the wildcard positions,
    the numerator init walk, and the blocked export (R = 1 wildcard term
    included) equal."""
    jf, tf = pair["j"]["fsas"][lm], pair["t"]["fsas"][lm]
    assert tf.committed and jf.committed
    for f in _FSA:
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f),
                                      err_msg=f)
    assert (tf.num_positions, tf.num_states, tf.start_pos) == (
        jf.num_positions, jf.num_states, jf.start_pos)
    assert tf.enter_state == jf.enter_state
    assert tf.loop_state == jf.loop_state
    assert tf.pos_trans == jf.pos_trans
    assert tf.wildcard_positions == jf.wildcard_positions
    for s in pair["seqs"][:5]:
        for a, b in zip(tf.init_lookup_seq(pair["t"]["lms"][lm], s),
                        jf.init_lookup_seq(pair["j"]["lms"][lm], s)):
            np.testing.assert_array_equal(a, b)
    jb, tb = jf.to_blocked(), tf.to_blocked()
    assert tb.bcast_sel is not None and tb.bcast_sel.shape[1] == 1
    for f in _BLOCKED:
        np.testing.assert_array_equal(getattr(tb, f),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert (tb.enter_pad, tb.num_states, tb.num_pdfs) == (
        jb.enter_pad, jb.num_states, jb.num_pdfs)


def test_numerator_graphs_equal(pair):
    """numerator_graph and make_chunk_supervision on the +-1 tree: the
    pdf keyed on the successor, the committed arc weights, next_phone at
    the chunk's end (a phone, and -1 = utterance end)."""
    jlm, tlm = pair["j"]["lms"]["4gram"], pair["t"]["lms"]["4gram"]
    jtree, ttree = pair["j"]["tree"], pair["t"]["tree"]
    jtopo, ttopo = jgraphs.ChainTopology(P), tgraphs.ChainTopology(P)
    jf, tf = pair["j"]["fsas"]["4gram"], pair["t"]["fsas"]["4gram"]
    for s in pair["seqs"][:6]:
        ph = [int(x) for x in s[:5]]
        for nxt in (-1, int(s[5]) if len(s) > 5 else 2):
            a = tsup.numerator_graph(ph, tlm, ttopo, ttree, 12,
                                     next_phone=nxt)
            b = jgraphs.numerator_graph(ph, jlm, jtopo, jtree, 12,
                                        next_phone=nxt)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            e, l = tf.init_lookup_seq(tlm, s)
            kw = dict(tol=2, init_ctx=tlm.walk_init(), next_phone=nxt)
            st = tgraphs.make_chunk_supervision(
                ph, [0, 2, 4, 6, 8], [1, 3, 5, 7, 9], tlm, ttopo, ttree, 10,
                12, den_init_seq=(e[:5], l[:5]), **kw)
            e, l = jf.init_lookup_seq(jlm, s)
            sj = jgraphs.make_chunk_supervision(
                ph, [0, 2, 4, 6, 8], [1, 3, 5, 7, 9], jlm, jtopo, jtree, 10,
                12, den_init_seq=(e[:5], l[:5]), **kw)
            for f in ("trans", "state_pdf", "init", "final", "mask",
                      "next_w"):
                np.testing.assert_array_equal(getattr(st, f),
                                              getattr(sj, f), err_msg=f)


def _obs(num_pdfs, b=3, t=10, seed=1):
    return np.random.RandomState(seed).randn(b, t, num_pdfs).astype(
        np.float32)


def test_plain_scan_matches_xla_on_committed_den(pair):
    """The port's own export through its plain scan against the XLA
    ``_blocked_score_core`` on the JAX export (the Pallas kernel has no
    wildcard term): logZ and the obs gradient within the reference's
    atol 2e-5 (tests/test_pallas_fwdbwd.py:102,108)."""
    jb = pair["j"]["fsas"]["4gram"].to_blocked()
    tb = pair["t"]["fsas"]["4gram"].to_blocked()
    obs = _obs(tb.num_pdfs)
    g = tfwd.BlockedDenGraph.from_host(tb, "cpu")
    o = torch.tensor(obs, requires_grad=True)
    z = tfwd.forward_score_blocked(o, g, leaky_coef=0.1)
    z.sum().backward()
    zj = np.asarray(jfwd.forward_score_blocked(jnp.asarray(obs), jb, 0.1))
    gj = np.asarray(jax.grad(lambda x: jnp.sum(jfwd.forward_score_blocked(
        x, jb, 0.1)))(jnp.asarray(obs)))
    np.testing.assert_allclose(z.detach().numpy(), zj, atol=2e-5)
    np.testing.assert_allclose(o.grad.numpy(), gj, atol=2e-5)


@pytest.mark.parametrize("obs_dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernels_on_committed_den(pair, obs_dtype):
    """The kernels' arithmetic with the wildcard term (3xTF32 products,
    group sums of beta, z = v . vec, the dot's group term) against the
    plain scan, at chip_smoke.py's bars: logZ within 1e-3, the gradient
    within 1e-3 (float32) / 1e-2 (bf16) of its largest entry."""
    tb = pair["t"]["fsas"]["4gram"].to_blocked()
    g = tfwd.BlockedDenGraph.from_host(tb, "cpu")
    rng = np.random.RandomState(0)
    logits = torch.tensor(_obs(tb.num_pdfs, b=4, t=9) * 2)
    obs = torch.exp(torch.clamp(logits - logits.amax(-1, keepdim=True),
                                min=-30.0))
    obs_v = obs.to(obs_dtype).index_select(-1, g.pdf_virtual).contiguous()
    gbar = torch.tensor(rng.rand(4).astype(np.float32) + 0.5)
    ze, ae, ce = bdc.blocked_scan_fwd_emulated(obs_v, g, 0.1)
    zp, ap, cp = bdc.blocked_scan_fwd_plain(obs_v, g, 0.1)
    assert float((ze - zp).abs().max()) <= 1e-3
    torch.testing.assert_close(ae, ap.float(), rtol=1e-3, atol=1e-6)
    for splits in (1, 3):
        ge = bdc.blocked_scan_bwd_emulated(obs_v, g, ae, ce, gbar,
                                           splits=splits)
        gp = bdc.blocked_scan_bwd_plain(obs_v, g, ap, cp, gbar)
        tol = 1e-3 if obs_dtype == torch.float32 else 1e-2
        assert float((ge.float() - gp.float()).abs().max()) <= tol * max(
            float(gp.float().abs().max()), 1.0)
    gid, vec, r = bdc._wildcard(g)
    assert r == 1 and vec.shape == (1, g.w_blocks.shape[0]
                                    * g.w_blocks.shape[2])
    np.testing.assert_array_equal(
        gid.numpy(), np.where(tb.bcast_sel[:, 0] > 0, 0, -1))


_MODEL = dict(feat_dim=12, ivector_dim=0, hidden_dim=32, bottleneck_dim=8,
              time_strides=(1, 3), prefinal_big=32, prefinal_small=16,
              compute_dtype="float32")


def _build(pkg):
    """(bundle, model_cfg, batch) of a +-1 tree through one package."""
    if pkg == "jax":
        from tdnnf_nas_tpu import data, graphs, models
        from tdnnf_nas_tpu.recipes.chain_recipes import prepare_data
    else:
        from tdnnf_nas_torch import data, graphs, models
        from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    corpus_cfg = data.SyntheticCorpusConfig(num_utts=32, num_phones=P,
                                            feat_dim=12)
    utts, phone_seqs, _, topo = data.make_synthetic_corpus(corpus_cfg)
    stats = graphs.accumulate_cross_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts], P,
        corpus_cfg.frame_subsampling_factor)
    tree = graphs.build_clustered_cross_triphone_tree(stats, num_leaves=20)
    bundle = prepare_data(utts, phone_seqs, tree, topo, P, phone_lm_order=4,
                          num_extra_lm_states=40)
    model_cfg = models.TdnnfModelConfig(num_pdfs=tree.num_pdfs, **_MODEL)
    chunks = bundle.egs(model_cfg, chunk_width=16, max_phones_per_chunk=12)
    batch = next(data.batch_iterator(chunks, batch_size=4,
                                     rng=np.random.RandomState(0)))
    return bundle, model_cfg, batch, chunks


@pytest.fixture(scope="module")
def train_setup():
    return _build("jax"), _build("torch")


def test_pm1_bundle_and_chunks_equal(train_setup):
    """prepare_data routes the +-1 tree to the committed den, whose blocked
    export carries the wildcard term; every chunk's supervision (the last
    pdf and arc from the chunk's true successor) equals the reference's."""
    (jb, _, jbatch, jchunks), (tb, _, tbatch, tchunks) = train_setup
    assert tb.den_fsa.committed and tb.den_arrays.bcast_sel is not None
    for f in _BLOCKED:
        np.testing.assert_array_equal(getattr(tb.den_arrays, f),
                                      np.asarray(getattr(jb.den_arrays, f)),
                                      err_msg=f)
    assert len(tchunks) == len(jchunks) > 0
    for a, b in zip(tchunks, jchunks):
        np.testing.assert_array_equal(a.feats, b.feats)
        for f in ("trans", "state_pdf", "init", "final", "mask", "next_w"):
            np.testing.assert_array_equal(getattr(a.sup, f),
                                          getattr(b.sup, f), err_msg=f)
    np.testing.assert_array_equal(tbatch["feats"], jbatch["feats"])


def test_pm1_three_steps_match_jax(train_setup):
    """Three float32 steps on the +-1 bundle from the same state: objf_mmi
    within 5e-4 of the JAX package's (the bar of __graft_entry__.py:119),
    whose den takes the XLA scan with the wildcard term."""
    from tdnnf_nas_tpu.train import TrainerConfig as JTrainerConfig
    from tdnnf_nas_tpu.train import init_train_state as jinit
    from tdnnf_nas_tpu.train import make_train_step as jmake
    from tdnnf_nas_torch.train import TrainerConfig, make_train_step

    (jb, jcfg, jbatch, _), (tb, tcfg, tbatch, _) = train_setup
    jtc = JTrainerConfig()
    jst = jinit(jcfg, jtc, jax.random.PRNGKey(2))
    jstep = jmake(jcfg, jtc, jb.den_arrays, donate=False)
    tst = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jst.params),
        jax.tree.map(np.asarray, jst.bn_state),
        jax.tree.map(np.asarray, jst.opt_state), int(jst.step),
        device="cpu")
    tstep = make_train_step(tcfg, TrainerConfig(),
                            tfwd.BlockedDenGraph.from_host(tb.den_arrays,
                                                           "cpu"))
    jbd = jax.tree.map(jnp.asarray, jbatch)
    tbd = convert.batch_to_torch(tbatch, device="cpu")
    jtraj, ttraj = [], []
    for _ in range(3):
        jst, jm = jstep(jst, jbd, jax.random.PRNGKey(3))
        tst, tm = tstep(tst, tbd)
        jtraj.append(float(jm["objf_mmi"]))
        ttraj.append(float(tm["objf_mmi"]))
    assert all(np.isfinite(ttraj)), ttraj
    delta = max(abs(a - b) for a, b in zip(jtraj, ttraj))
    assert delta < 5e-4, (delta, jtraj, ttraj)


def test_hclg_sparse_pm1_tree_matches_jax():
    """The sparse HCLG of a +-1 tree (within-word successors, word-final
    phones on the r = -1 class) equals the reference's."""
    kw = dict(vocab_size=14, num_phones=8, feat_dim=16, num_utts=20,
              min_words=2, max_words=5, right_context_shift=0.5, seed=5)
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**kw))
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**kw))
    trees = []
    for g, corpus in ((jgraphs, j), (tgraphs, t)):
        utts = corpus[0]
        stats = g.accumulate_cross_triphone_stats(
            [u.feats for u in utts], [u.phones for u in utts],
            [u.begins for u in utts], 8, 3)
        trees.append(g.build_clustered_cross_triphone_tree(stats,
                                                           num_leaves=24))
    sym = [f"w{w}" for w in range(kw["vocab_size"])]
    sents = [[sym[w] for w in ws] for ws in j[2]]
    jg = jgs.build_hclg_sparse(jwfst.Lexicon(j[1]),
                               jng.estimate_ngram_lm(sents, order=3), sym,
                               j[5], trees[0])
    tg = tgs.build_hclg_sparse(twfst.Lexicon(t[1]),
                               tng.estimate_ngram_lm(sents, order=3), sym,
                               t[5], trees[1])
    assert (tg.num_states, tg.num_pdfs, tg.num_arcs) == (
        jg.num_states, jg.num_pdfs, jg.num_arcs)
    for f in ("out_start", "arc_dst", "arc_w", "arc_word", "state_pdf",
              "final_w"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f),
                                      err_msg=f)


def test_bootstrap_stage_pm1_matches_reference():
    """e2e stages 1-2 on the CPU: the ladder's alignments, then the +-1
    tree, equal to the reference's bootstrap_alignments_gmm followed by
    its cross-triphone clustering; the left-2 kind builds a TriphoneTree."""
    import tdnnf_nas_tpu.gmm as jgmm
    import tdnnf_nas_torch.gmm as tgmm
    from tdnnf_nas_tpu.recipes.chain_recipes import bootstrap_alignments_gmm
    from tdnnf_nas_torch.tools.e2e_flagship import bootstrap_stage

    cfg = tsyn.SyntheticCorpusConfig(num_utts=16, num_phones=P, feat_dim=10,
                                     mean_dur=4.0, seed=3)
    utts, phone_seqs, _, _ = tsyn.make_synthetic_corpus(cfg)

    def ladder(mod):
        return mod.GmmLadderConfig(
            mono=mod.MonoHmmConfig(num_iters=3, max_mix=2,
                                   mix_up_iters=(1,)),
            lda_dim=8, mllt_iters=2, lda_mllt_em_iters=2, sat_em_iters=2,
            fmllr_iters=2)

    uj = copy.deepcopy(utts)
    bootstrap_alignments_gmm(uj, phone_seqs, P, ladder_cfg=ladder(jgmm))
    stats = jgraphs.accumulate_cross_triphone_stats(
        [u.feats for u in uj], phone_seqs, [u.begins for u in uj], P, 3)
    jtree = jgraphs.build_clustered_cross_triphone_tree(stats, num_leaves=15)
    ut = copy.deepcopy(utts)
    tree, res, secs = bootstrap_stage(ut, phone_seqs, P, ladder(tgmm), 15,
                                      tree_kind="pm1", device="cpu")
    assert [u.begins for u in ut] == [u.begins for u in uj] == res.begins
    assert isinstance(tree, tgraphs.CrossTriphoneTree)
    np.testing.assert_array_equal(tree._fwd_table, jtree._fwd_table)
    assert set(secs) == {"gmm", "tree"}
    tree2, _, _ = bootstrap_stage(copy.deepcopy(utts), phone_seqs, P,
                                  ladder(tgmm), 15, device="cpu")
    assert isinstance(tree2, tgraphs.TriphoneTree)
    with pytest.raises(ValueError, match="tree_kind"):
        bootstrap_stage(ut, phone_seqs, P, ladder(tgmm), 15,
                        tree_kind="left1", device="cpu")
