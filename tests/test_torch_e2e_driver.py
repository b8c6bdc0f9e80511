"""The port's whole flagship run (``tools/e2e_flagship``, ``tools/e2e_search``)
against ``scripts/e2e_flagship.py`` on the CPU: the two presets against
the reference's ``FLAGSHIP_SMOKE`` switches, its configs, graph and LMs,
``build_setup`` at a small preset against the JAX chain of the same
functions, stage 9's extraction, contenders and table on the same
alphas, one small ``main all`` run and its three files, the smoke
sizes' short dev split, and the stages that the reference swallows,
which raise here."""

import ast
import contextlib
import copy
import dataclasses
import io
import json
import os
import types

import jax  # noqa: F401  (the reference runs in this process, on the CPU)
import numpy as np
import pytest
import torch

from tdnnf_nas_torch.tools import e2e_flagship as te2e
from tdnnf_nas_torch.tools import e2e_search as tsearch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A small preset: a few narrow layers, a 12-word vocabulary (an untrained
# model's lattices stay under ~0.5 M arcs), 2 test utterances
SMALL = dataclasses.replace(
    te2e.E2eSizes.smoke(), n_test=2, vocab_size=12, num_utts=120,
    num_text_sents=200, tri_leaves=30, train_subset=30, tree_leaves=20,
    ubm_utts=20, ubm_gauss=4, tmat_utts=30, extra_lm_states=10,
    train_steps=3, rnnlm_embed=16, rnnlm_hidden=32, rnnlm_steps=3,
    noiv_steps=2, ab_steps=2, pretrain_steps=2, cv_steps=2, child_steps=2,
    model_overrides=(("hidden_dim", 32), ("bottleneck_dim", 8),
                     ("time_strides", (1, 0, 3)), ("prefinal_big", 32),
                     ("prefinal_small", 16)))

# each SMOKE switch of the reference, by line, and the field holding it
_SWITCHES = {47: "n_test", 71: "vocab_size", 72: "num_utts",
             75: "num_text_sents", 151: "tri_leaves", 154: "train_subset",
             168: "tree_leaves", 176: "ubm_utts", 177: "ubm_gauss",
             180: "tmat_utts", 219: "extra_lm_states", 289: "train_steps",
             351: "rnnlm_embed", 352: "rnnlm_hidden", 353: "rnnlm_proj",
             354: "rnnlm_splice", 357: "rnnlm_steps", 411: "noiv_steps",
             436: "ab_steps", 597: "pretrain_steps", 598: "cv_steps",
             668: "child_steps"}
# switches of output paths, which the port replaces by --out
_PATHS = {52, 111, 456, 712}

# the keys the reference writes (scripts/e2e_flagship.py:93-98, 157-159,
# 195-196, 223-224, 298-301, 314-315, 325, 338, 380, 397, 422-423, 460;
# :446-455; :689-710)
_E2E_KEYS = {"corpus", "gmm", "ivectors", "tree_pdfs", "den_states", "train",
             "hclg", "wer_first_pass_tg", "wer_4gram_rescore",
             "wer_rnnlm_rescore", "lhuc", "lhuc_noiv", "bf16_parity"}
_NESTED = {
    "corpus": {"vocab", "phones", "train_utts", "test_utts", "audio_hours",
               "noise", "speakers", "lm_text_sents"},
    "gmm": {"fmllr_gain", "train_subset", "seconds"},
    "ivectors": {"dim", "within_spk_cos", "between_spk_cos"},
    "train": {"steps", "objf_mmi", "params", "seconds", "egs_stats"},
    "hclg": {"states", "arcs", "build_s"},
    "lhuc": {"speakers", "utts", "wer_before", "wer_after"},
    "lhuc_noiv": {"speakers", "utts", "wer_before", "wer_after",
                  "wer_unadapted_full"},
    "bf16_parity": {"delta_wer"},
}


def _reference():
    """``scripts/e2e_flagship.py`` as a module (its imports are lazy)."""
    import importlib.util

    path = os.path.join(REPO, "scripts", "e2e_flagship.py")
    spec = importlib.util.spec_from_file_location("_e2e_flagship_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _smoke_switches():
    """{line: (smoke value, full value)} of the reference's switches."""
    tree = ast.parse(open(os.path.join(REPO, "scripts",
                                       "e2e_flagship.py")).read())
    env = {"cfg": types.SimpleNamespace(num_phones=46), "TOPIC_SUCC": False}
    out = {}
    for n in ast.walk(tree):
        if (isinstance(n, ast.IfExp) and isinstance(n.test, ast.Name)
                and n.test.id == "SMOKE"):
            out[n.lineno] = tuple(eval(compile(ast.Expression(e), "<ref>",
                                               "eval"), dict(env))
                                  for e in (n.body, n.orelse))
        elif (isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not)
              and isinstance(n.operand, ast.Name)
              and n.operand.id == "SMOKE"):
            out[n.lineno] = (False, True)
    return out


@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_presets_equal_the_reference_switches(preset):
    """Every SMOKE switch of the reference is a field of E2eSizes, cited
    by its line, with the reference's value in each preset."""
    switches = _smoke_switches()
    assert set(switches) == set(_SWITCHES) | _PATHS
    sizes = getattr(te2e.E2eSizes, preset)()
    for line, field in _SWITCHES.items():
        smoke, full = switches[line]
        assert getattr(sizes, field) == (smoke if preset == "smoke"
                                         else full), (line, field)
    assert not sizes.topic_successors and sizes.model_overrides == ()
    fields = {f.name for f in dataclasses.fields(te2e.E2eSizes)}
    assert fields == set(_SWITCHES.values()) | {"topic_successors",
                                                "model_overrides"}


@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_corpus_and_ladder_configs_equal_the_reference(preset, monkeypatch):
    """The reference's build_setup, stopped at its first two calls, hands
    make_word_corpus and the GMM ladder the port's configs."""
    import tdnnf_nas_tpu.data.synthetic as jsyn
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    ref = _reference()
    ref.SMOKE = preset == "smoke"
    sizes = getattr(te2e.E2eSizes, preset)()
    seen, small = {}, _tiny_reference_corpus()

    def corpus(cfg):
        seen["corpus"] = cfg
        raise _Captured

    monkeypatch.setattr(jsyn, "make_word_corpus", corpus)
    with pytest.raises(_Captured):
        ref.build_setup()
    assert (dataclasses.asdict(seen["corpus"])
            == dataclasses.asdict(te2e.word_corpus_config(sizes)))

    def ladder(train, phones, num_phones, speakers=None, ladder_cfg=None):
        seen["ladder"] = ladder_cfg
        raise _Captured

    monkeypatch.setattr(jsyn, "make_word_corpus", lambda cfg: small)
    monkeypatch.setattr(jrec, "bootstrap_alignments_gmm", ladder)
    monkeypatch.setattr(ref.os.path, "exists", lambda p: False)
    monkeypatch.setattr(ref.os, "makedirs", lambda *a, **k: None)
    with pytest.raises(_Captured):
        ref.build_setup()
    assert (dataclasses.asdict(seen["ladder"])
            == dataclasses.asdict(te2e.ladder_config(sizes)))


def _tiny_reference_corpus():
    import tdnnf_nas_tpu.data.synthetic as jsyn

    cfg = te2e.word_corpus_config(SMALL)
    return jsyn.make_word_corpus(jsyn.WordCorpusConfig(
        **dataclasses.asdict(cfg)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_and_trainer_configs_equal_the_reference(dtype):
    ref = _reference()
    tree = types.SimpleNamespace(num_pdfs=400)
    cfg = te2e.word_corpus_config(te2e.E2eSizes.smoke())
    assert (te2e.model_config(tree, cfg, dtype).to_json()
            == ref.model_config(tree, cfg, dtype).to_json())
    for n in (120, 1600):
        assert (te2e.trainer_config(n).to_json()
                == ref.trainer_config(n).to_json())
    small = te2e.model_config(tree, cfg, dtype, SMALL.model_overrides)
    assert (small.hidden_dim, small.time_strides) == (32, (1, 0, 3))


def test_build_graph_equals_the_reference():
    """word_sym, the trigram and the 4-gram of a small corpus."""
    from tdnnf_nas_torch.data.synthetic import make_word_corpus

    ref = _reference()
    ref.N_TEST = SMALL.n_test
    cfg = te2e.word_corpus_config(SMALL)
    _, prons, word_seqs, _, _, _, text = make_word_corpus(cfg)
    t_sym, t3, t4 = te2e.build_graph(cfg, prons, word_seqs, text,
                                     SMALL.n_test)
    j_sym, j3, j4 = ref.build_graph(cfg, prons, word_seqs, text)
    assert t_sym == j_sym
    for t, j in ((t3, j3), (t4, j4)):
        assert t.order == j.order
        assert set(t.logprobs) == set(j.logprobs)
        for k, v in j.logprobs.items():
            assert t.logprobs[k] == pytest.approx(v, abs=1e-6)
        assert set(t.backoffs) == set(j.backoffs)
        for k, v in j.backoffs.items():
            assert t.backoffs[k] == pytest.approx(v, abs=1e-6)


@pytest.fixture(scope="module")
def chains():
    """build_setup at the small preset on the port, and the reference's
    chain of the same functions (``:70-224``) in the JAX package."""
    import tdnnf_nas_tpu.data.ivector as jiv
    import tdnnf_nas_tpu.gmm as jgmm
    import tdnnf_nas_tpu.graphs as jgraphs
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    report = te2e.Report()
    port = te2e.build_setup(SMALL, device="cpu", report=report)
    utts, prons, word_seqs, _, _, topo, text = _tiny_reference_corpus()
    test, train = utts[:SMALL.n_test], utts[SMALL.n_test:]
    phones = [u.phones for u in train]
    raw = [copy.deepcopy(u.begins) for u in train]
    lc = te2e.ladder_config(SMALL)
    jrec.bootstrap_alignments_gmm(
        train, phones, 46, speakers=[u.speaker for u in train],
        ladder_cfg=jgmm.GmmLadderConfig(
            mono=jgmm.MonoHmmConfig(**dataclasses.asdict(lc.mono)),
            **{k: v for k, v in dataclasses.asdict(lc).items()
               if k != "mono"}))
    stats = jgraphs.accumulate_triphone_stats(
        [u.feats for u in train], phones, [u.begins for u in train], 46, 3)
    tree = jgraphs.build_clustered_triphone_tree(stats,
                                                 num_leaves=SMALL.tree_leaves)
    pool = np.concatenate([u.feats for u in train[:SMALL.ubm_utts]])[::2]
    ubm = jiv.train_ubm(pool, jiv.UbmConfig(num_gauss=SMALL.ubm_gauss,
                                            em_iters=6))
    t_mat = jiv.train_ivector_extractor(
        [u.feats for u in train[:SMALL.tmat_utts]], ubm,
        jiv.IvectorConfig(dim=100, em_iters=4))
    ivecs = np.asarray(jiv.extract_ivectors([u.feats for u in utts], ubm,
                                            t_mat))
    bundle = jrec.prepare_data(train, phones, tree, topo, 46,
                               dev_fraction=0.05, phone_lm_order=4,
                               num_extra_lm_states=SMALL.extra_lm_states,
                               ivectors=list(ivecs[SMALL.n_test:]))
    jax_side = dict(utts=utts, prons=prons, word_seqs=word_seqs, text=text,
                    test=test, train=train, raw_begins=raw, tree=tree,
                    ivecs=ivecs, bundle=bundle)
    return dict(port=port, report=report, jax=jax_side)


def test_setup_corpus_equals_jax(chains):
    p, j = chains["port"], chains["jax"]
    assert len(p.utts) == len(j["utts"]) == SMALL.num_utts
    assert len(p.test) == SMALL.n_test
    assert p.prons == j["prons"]
    assert p.word_seqs == j["word_seqs"] and p.text == j["text"]
    for a, b in zip(p.utts, j["utts"]):
        np.testing.assert_array_equal(a.feats, b.feats)
        assert list(a.phones) == list(b.phones)
        assert list(a.words) == list(b.words) and a.speaker == b.speaker
    corpus = chains["report"].e2e["corpus"]
    frames = sum(len(u.pdf_align) for u in j["utts"])
    assert corpus == {"vocab": 12, "phones": 46, "train_utts": 118,
                      "test_utts": 2, "audio_hours": round(
                          frames * 0.03 / 3600, 2), "noise": 4.5,
                      "speakers": 40, "lm_text_sents": 200}


def test_setup_bootstrap_equals_jax(chains):
    """The ladder's alignments (they moved from the generator's) and the
    left-2 tree built on them."""
    p, j = chains["port"], chains["jax"]
    assert [u.begins for u in p.train] == [u.begins for u in j["train"]]
    assert [u.ends for u in p.train] == [u.ends for u in j["train"]]
    assert [u.begins for u in j["train"]] != j["raw_begins"]
    assert p.tree.num_pdfs == j["tree"].num_pdfs
    np.testing.assert_array_equal(p.tree._fwd_table, j["tree"]._fwd_table)
    assert chains["report"].e2e["tree_pdfs"] == j["tree"].num_pdfs
    assert set(chains["report"].e2e["gmm"]) == _NESTED["gmm"]


def test_setup_ivectors_equal_jax(chains):
    """UBM, T-matrix and extraction chained on each side: each i-vector
    at cosine >= 0.9999 and within 1e-3 of its norm
    (tests/test_torch_ivector.py's bars)."""
    a, b = np.concatenate([chains["port"].iv_test, chains["port"].iv_train]), \
        chains["jax"]["ivecs"]
    assert a.shape == b.shape == (SMALL.num_utts, 100)
    cos = np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                              * np.linalg.norm(b, axis=1))
    assert cos.min() >= 0.9999
    err = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    assert err.max() <= 1e-3
    iv = chains["report"].e2e["ivectors"]
    assert iv["dim"] == 100 and iv["within_spk_cos"] > iv["between_spk_cos"]


def test_setup_den_equals_jax(chains):
    """The composed 4-gram den: its states, and the blocked export."""
    from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph

    p, j = chains["port"].bundle, chains["jax"]["bundle"]
    assert p.den_fsa.num_states == j.den_fsa.num_states
    assert chains["report"].e2e["den_states"] == j.den_fsa.num_states
    assert isinstance(p.den_arrays, BlockedDenGraph)
    assert type(j.den_arrays).__name__ == "BlockedDenGraph"
    assert len(p.train_utts) == len(j.train_utts)
    assert len(p.dev_utts) == len(j.dev_utts)


# ---- stage 9 on the same alphas, model steps replaced by stand-ins ----

def _alpha_table(seed, dup):
    rng = np.random.RandomState(seed)
    a = {s: (rng.randn(14, 4).astype(np.float32) * 2,
             rng.randn(14, 4).astype(np.float32) * 2) for s in (1, 11)}
    if dup:
        a[11] = a[1]
    return a


def _stage9_world():
    tree = types.SimpleNamespace(num_pdfs=400)
    cfg = te2e.word_corpus_config(te2e.E2eSizes.smoke())
    bundle = types.SimpleNamespace(
        egs=lambda *a, **k: list(range(100)), den_arrays=None)
    test = [None] * 20
    return tree, cfg, bundle, test


def _reference_table(alphas, monkeypatch):
    """The reference's run_search with its model steps, valid steps and
    decodes replaced: the stand-ins hand back each cv seed's alphas, a
    parameter count per config and fixed scores."""
    import tdnnf_nas_tpu.data.egs as jegs
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec
    import tdnnf_nas_tpu.train as jtrain

    ref = _reference()
    ref.SMOKE = True
    tree, cfg, bundle, test = _stage9_world()

    def train(bundle, cfg_, tc, n, **kw):
        st = types.SimpleNamespace(params=cfg_, alphas={})
        if kw.get("supernet") and tc.train_alpha:
            a_lin, a_aff = alphas[kw["seed"]]
            st.alphas = {"offsets_linear": a_lin, "offsets_affine": a_aff}
        return st, types.SimpleNamespace(last=lambda k: -0.123456)

    monkeypatch.setattr(jrec, "train_model", train)
    monkeypatch.setattr(jrec, "decode_corpus_words",
                        lambda *a, **k: {"wer": 12.3456})
    monkeypatch.setattr(jtrain, "make_valid_step",
                        lambda *a: lambda st, b: {"objf_mmi": -0.25})
    monkeypatch.setattr(jegs, "batch_iterator",
                        lambda *a: iter([{"x": np.zeros(1)}] * 10))
    monkeypatch.setattr(jmodels, "count_params",
                        lambda cfg_: sum(map(sum, cfg_.stride_pairs)))
    written = io.StringIO()
    ref.open = lambda *a, **k: contextlib.nullcontext(written)
    shared = ((cfg, None, None, None, None, bundle, tree, None, test, None,
               [None] * 20, None), None, "G", None, None)
    ref.run_search(shared)
    return json.loads(written.getvalue())


def _port_table(alphas, monkeypatch, n_chunks=100):
    """The port's run_search with the same stand-ins; the supernet's and
    the cv-updates' batch sizes land in ``report.batches``."""
    tree, cfg, bundle, test = _stage9_world()
    bundle.egs = lambda *a, **k: list(range(n_chunks))
    batches = {}

    def train(bundle, cfg_, tc, n, batch_size, **kw):
        if kw.get("supernet"):
            batches["cv" if tc.train_alpha else "supernet"] = batch_size
        st = types.SimpleNamespace(params=cfg_, alphas={})
        if kw.get("supernet") and tc.train_alpha:
            st.alphas = {k: torch.tensor(v) for k, v in zip(
                ("offsets_linear", "offsets_affine"), alphas[kw["seed"]])}
        return st, types.SimpleNamespace(
            last=lambda k: -0.123456,
            series={"objf_mmi": [(i, -0.1) for i in range(n)]})

    monkeypatch.setattr(tsearch, "train_model", train)
    monkeypatch.setattr(tsearch, "decode", lambda *a, **k: {"wer": 12.3456})
    monkeypatch.setattr(tsearch, "make_valid_step",
                        lambda *a: lambda st, b: {"objf_mmi": -0.25})
    monkeypatch.setattr(tsearch, "den_on_device", lambda *a: None)
    monkeypatch.setattr(tsearch, "batch_iterator",
                        lambda *a: iter([{"x": np.zeros(1)}] * 10))
    monkeypatch.setattr(tsearch.convert, "batch_to_torch", lambda b, d: b)
    monkeypatch.setattr(tsearch, "count_params",
                        lambda cfg_: sum(map(sum, cfg_.stride_pairs)))
    setup = types.SimpleNamespace(sizes=te2e.E2eSizes.smoke(), cfg=cfg,
                                  tree=tree, bundle=bundle, test=test)
    report = te2e.Report()
    out = tsearch.run_search(setup, te2e.BaseRun(None, None, "G"), report,
                             device="cpu")
    report.batches = batches
    return out, report


@pytest.mark.parametrize("seed,dup", [(0, False), (1, False), (2, True)])
def test_search_table_equals_the_reference_on_the_same_alphas(
        seed, dup, monkeypatch):
    """Entropies, the top-1/top-2 and seed-2 extraction and agreement, the
    random archs of RandomState(123/456), the contenders (the seed-2 row
    dropped when it equals top-1), each row's strides, lookahead reach
    and rounding."""
    alphas = _alpha_table(seed, dup)
    want = _reference_table(alphas, monkeypatch)
    got, report = _port_table(alphas, monkeypatch)
    assert json.loads(json.dumps(got)) == want
    assert len(want["table"]) == (5 if dup else 6)
    assert report.valid_batches == 6 * len(want["table"])
    assert report.steps["cv_1"] == report.steps["cv_11"] == 60


def test_rand_arch_and_lookahead_reach():
    rng = np.random.RandomState(123)
    want = tuple((int(rng.randint(0, 4)), int(rng.randint(0, 4)))
                 for _ in range(14))
    assert tsearch.rand_arch(123, 14) == want
    mc = te2e.model_config(types.SimpleNamespace(num_pdfs=9),
                           te2e.word_corpus_config(SMALL))
    # the manual 7q sees 1 + 33 + 2 output frames ahead (:78-79)
    assert tsearch.lookahead_reach(tsearch.stride_pairs(mc)) == 36


def test_smoke_dev_split_is_short_of_the_search_batch(monkeypatch):
    """At the reference's smoke sizes the dev split holds 47 chunks, one
    short of the cv-update's batch of 48: the reference's train_model
    raises there; the port's cv-update steps on batches of 47, and the
    supernet on the training split keeps 48."""
    import tdnnf_nas_tpu.data.synthetic as jsyn
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    sizes = te2e.E2eSizes.smoke()
    cfg = jsyn.WordCorpusConfig(**dataclasses.asdict(
        te2e.word_corpus_config(sizes)))
    utts, _, _, _, tree, topo, _ = jsyn.make_word_corpus(cfg)
    train = utts[sizes.n_test:]
    bundle = jrec.prepare_data(train, [u.phones for u in train], tree, topo,
                               46, dev_fraction=0.05)
    darts = jmodels.DartsModelConfig(
        base=jmodels.TdnnfModelConfig(num_pdfs=tree.num_pdfs),
        search_offsets=True, max_stride=3)
    n_dev = len(bundle.egs(None, chunk_width=50, dev=True,
                           supernet_cfg=darts))
    assert n_dev == 47
    with pytest.raises(ValueError, match="only 47 chunks for batch 48"):
        jrec.train_model(bundle, darts, None, 1, batch_size=48,
                         chunk_width=50, supernet=True, dev=True)
    _, report = _port_table(_alpha_table(0, False), monkeypatch,
                            n_chunks=n_dev)
    assert report.batches == {"supernet": 48, "cv": 47}
    _, report = _port_table(_alpha_table(0, False), monkeypatch)
    assert report.batches == {"supernet": 48, "cv": 48}


# ---- one small whole run ----

@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("e2e")
    res = te2e.main(["all", "--out", str(out)], device="cpu", sizes=SMALL)
    files = {}
    for what, name in te2e.Report.FILES.items():
        with open(out / name) as f:
            files[what] = json.load(f)
    return res, files


def test_main_writes_the_reference_keys(small_run):
    _, files = small_run
    e2e, ab, search = files["e2e"], files["bf16"], files["search"]
    assert set(e2e) == _E2E_KEYS
    for k, keys in _NESTED.items():
        assert set(e2e[k]) == keys, k
    assert set(e2e["train"]["egs_stats"]) == set(json.load(open(os.path.join(
        REPO, "docs", "e2e_flagship.json")))["train"]["egs_stats"])
    ref_ab = json.load(open(os.path.join(REPO, "docs", "bf16_parity.json")))
    assert set(ab) == set(ref_ab)
    for d in ("bfloat16", "float32"):
        assert set(ab[d]) == set(ref_ab[d])
    ref_search = json.load(open(os.path.join(
        REPO, "docs", "search_table_flagship.json")))
    assert set(search) == set(ref_search)
    assert set(search["table"]) <= set(ref_search["table"])
    assert len(search["table"]) in (5, 6)
    row = set(ref_search["table"]["manual_baseline"])
    assert all(set(r) == row for r in search["table"].values())


def test_main_values_and_rounding(small_run):
    """The reference's rounding, and the A/B difference of its WERs."""
    res, files = small_run
    e2e, ab, search = files["e2e"], files["bf16"], files["search"]
    for v in (e2e["wer_first_pass_tg"], e2e["wer_4gram_rescore"],
              e2e["wer_rnnlm_rescore"], e2e["lhuc"]["wer_after"],
              ab["float32"]["wer"]):
        assert v == round(v, 2) and v >= 0
    assert e2e["train"]["objf_mmi"] == round(e2e["train"]["objf_mmi"], 4)
    assert np.isfinite(e2e["train"]["objf_mmi"])
    assert ab["delta_wer"] == round(ab["bfloat16"]["wer"]
                                    - ab["float32"]["wer"], 2)
    assert e2e["bf16_parity"] == {"delta_wer": ab["delta_wer"]}
    assert len(ab["bfloat16"]["objf_curve_10"]) == 1  # steps 0, 60, ...
    assert search["table"]["manual_baseline"]["params"] \
        == e2e["train"]["params"]
    assert search["table"]["manual_baseline"]["lookahead_reach"] == 1 + 4 + 2
    assert all(len(r["strides"]) == 3 for r in search["table"].values())
    assert set(res.report.seconds) >= {"4 train", "8 bf16 A/B",
                                       "9 supernet"}


def test_main_counts_every_step(small_run):
    """Each train_model run's steps, 24 LHUC steps a speaker in both
    passes, and 6 valid batches a table row."""
    res, files = small_run
    rep, e2e = res.report, files["e2e"]
    table = files["search"]["table"]
    assert rep.steps == {
        "train": 3, "noiv": 2, "ab_bfloat16": 2, "ab_float32": 2,
        "supernet": 2, "cv_1": 2, "cv_11": 2,
        **{f"child_{k}": 2 for k in table}}
    assert rep.lhuc_steps == 24 * (e2e["lhuc"]["speakers"]
                                   + e2e["lhuc_noiv"]["speakers"]) > 0
    assert rep.valid_batches == 6 * len(table)


# ---- the stages the reference swallows raise here ----

@pytest.fixture(scope="module")
def small_setup():
    return te2e.build_setup(SMALL, device="cpu")


def _boom(*a, **k):
    raise RuntimeError("boom")


@pytest.mark.parametrize("stage", ["rnnlm", "lhuc", "lhuc_noiv", "ab"])
def test_a_failing_stage_raises(stage, small_setup, monkeypatch, capsys):
    """RNNLM rescoring, LHUC, the no-i-vector LHUC and the A/B (wrapped
    in ``except Exception: ... skipped`` at scripts/e2e_flagship.py:378,
    398, 424, 461) raise through run_base, and nothing says skipped.  The
    4-gram rescoring and the n-best lists are stood in for to keep the
    run short."""
    monkeypatch.setattr(te2e, "rescore_lattice", lambda *a, **k: [])
    monkeypatch.setattr(te2e, "lattice_nbest",
                        lambda lat, n: [([0], 0.0)])
    if stage == "rnnlm":
        monkeypatch.setattr(te2e, "train_rnnlm", _boom)
    elif stage == "lhuc":
        monkeypatch.setattr(te2e, "lhuc_adapt_and_decode", _boom)
    else:
        res = {"speakers": 1, "utts": 1, "wer_before": 1.0,
               "wer_after": 1.0}
        if stage == "lhuc_noiv":
            monkeypatch.setattr(
                te2e, "lhuc_adapt_and_decode",
                lambda *a, **k: res if a[10] else _boom())
        else:
            monkeypatch.setattr(te2e, "lhuc_adapt_and_decode",
                                lambda *a, **k: res)
            monkeypatch.setattr(tsearch, "bf16_ab", _boom)
    with pytest.raises(RuntimeError, match="boom"):
        te2e.run_base(small_setup, device="cpu")
    assert "skipped" not in capsys.readouterr().out
