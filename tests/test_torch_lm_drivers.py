"""The port's flagship-set-up drivers and the WER demo
(``tools/lhuc_regularized``, ``tools/rnnlm_fair_fight``,
``tools/wer_synthetic``) against the reference scripts of the same names
on the CPU: each run by the reference's own code and by the port's with
the same stand-ins, so every config, call, table and choice is held to
the reference's (the LHUC rows and best variant; the fair fight's tg ->
fg swap, dev / eval halves, oracle and weight sweep on the same n-best
lists and converted RNNLM parameters; the WER demo's bucketed forward
and rescorings on converted model parameters); one small ``main`` of
each; and the patch and the native lattices, which raise where the
reference printed and went on."""

import contextlib
import dataclasses
import io
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.lm.rnnlm import RnnLMConfig, init_rnnlm
from tdnnf_nas_torch.tools import e2e_flagship as te2e
from tdnnf_nas_torch.tools import lhuc_regularized as tlr
from tdnnf_nas_torch.tools import rnnlm_fair_fight as trf
from tdnnf_nas_torch.tools import wer_synthetic as tws
from tests.test_torch_e2e_driver import SMALL
from tests.test_torch_search_experiments import (_World, _doc, _reference,
                                                 _rounded, _small_decodes)

torch.set_num_threads(2)

N_TEST = 4
VOCAB = 12


def _fake_fs(ref, reads=None, environ=None):
    """The reference's ``open`` and ``os`` on buffers: ``reads`` {path:
    text} are the files that exist; each write opens a fresh buffer
    (text or bytes): {path: the last one}."""
    reads = dict(reads or {})
    bufs = {}

    def fake_open(path, mode="r", *a, **k):
        if mode in ("w", "wb"):
            bufs[path] = io.BytesIO() if "b" in mode else io.StringIO()
            return contextlib.nullcontext(bufs[path])
        if path not in reads:
            raise FileNotFoundError(path)
        return contextlib.nullcontext(io.StringIO(reads[path]))

    ref.open = fake_open
    ref.os = types.SimpleNamespace(
        path=types.SimpleNamespace(exists=lambda p: p in reads,
                                   join=os.path.join, dirname=os.path.dirname,
                                   abspath=os.path.abspath),
        environ=dict(environ or {}), makedirs=lambda *a, **k: None)
    return bufs


def _word_world(seed=0):
    """Small word data both sides share: (cfg, prons, word_seqs, text,
    test utterances)."""
    rng = np.random.RandomState(seed)
    sents = lambda n: [list(rng.randint(0, VOCAB, rng.randint(2, 6)))
                       for _ in range(n)]
    word_seqs, text = sents(40), sents(200)
    test = [types.SimpleNamespace(words=list(ws), speaker=i % 2)
            for i, ws in enumerate(word_seqs[:N_TEST])]
    prons = {w: (w % 5, (w + 1) % 5) for w in range(VOCAB)}
    cfg = te2e.word_corpus_config(dataclasses.replace(
        te2e.E2eSizes.smoke(), vocab_size=VOCAB))
    return cfg, prons, word_seqs, text, test


def _setups(topic_successors=False):
    """The reference's set-up tuple and the port's ``Setup`` of the same
    word world; the model and den parts are stand-ins."""
    cfg, prons, word_seqs, text, test = _word_world()
    cfg = dataclasses.replace(cfg, topic_successors=topic_successors)
    tree = types.SimpleNamespace(num_pdfs=50)
    iv = np.zeros((N_TEST, 100), np.float32)
    ref = (cfg, None, prons, word_seqs, text, "bundle", tree, "topo", test,
           None, iv, None)
    sizes = dataclasses.replace(te2e.E2eSizes.full(), n_test=N_TEST,
                                vocab_size=VOCAB,
                                topic_successors=topic_successors)
    port = te2e.Setup(sizes=sizes, cfg=cfg, utts=None, prons=prons,
                      word_seqs=word_seqs, text=text, bundle="bundle",
                      tree=tree, topo="topo", test=test, train=None,
                      iv_test=iv, iv_train=None)
    return ref, port


def _hclg_standin(seen):
    def build(lexicon, lm, word_sym, topo, tree, **kw):
        seen.append((len(lm.logprobs), list(word_sym), topo, tree.num_pdfs,
                     sorted(lexicon.prons.items()), kw))
        return "G"
    return build


def _jax_common(monkeypatch, world, ref, seen):
    import tdnnf_nas_tpu.decode.graph_sparse as jgs
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    monkeypatch.setattr(jrec, "train_model", world.train)
    monkeypatch.setattr(jrec, "decode_corpus_words", world.decode)
    monkeypatch.setattr(jgs, "build_hclg_sparse", _hclg_standin(seen))
    monkeypatch.setattr(ref.flag, "_save", lambda *a, **k: None)


def _port_common(monkeypatch, world, mod, seen):
    monkeypatch.setattr(mod, "train_model", world.train)
    if hasattr(mod, "decode_corpus_words"):
        monkeypatch.setattr(mod, "decode_corpus_words", world.decode)
    monkeypatch.setattr(te2e, "decode_corpus_words", world.decode)
    monkeypatch.setattr(te2e, "build_hclg_sparse", _hclg_standin(seen))


# ---- lhuc_regularized ----

def _lhuc_standin(calls, torch_side):
    """lhuc_adapt_and_decode's stand-in: records each call's flags and
    keywords; the port's returns unrounded figures and its extra key."""
    def adapt(bundle, topo, tree, g, test, refs, iv_test, objective, mc_l,
              state_l, use_iv, base_hyps, num_steps=24, lr=0.2, l2=0.0,
              **kw):
        calls.append((g, refs, dataclasses.asdict(objective),
                      mc_l.to_json(), use_iv, len(base_hyps), num_steps, lr,
                      l2))
        after = 10.0 - l2 + num_steps / 1000 + 0.004321
        row = {"speakers": 2, "utts": len(test), "wer_before": 11.004321,
               "wer_after": after}
        if torch_side:
            return dict(row, max_abs_logit=[0.5, 0.25])
        return {k: round(v, 2) for k, v in row.items()}
    return adapt


def test_lhuc_sweep_equals_the_reference(tmp_path, monkeypatch):
    """The reference's main and the port's, on the same set-up with
    training, the HCLG, decodes and LHUC stood in for: the same train and
    decode calls, the same three LHUC calls (no i-vectors, the stage-7b
    model, each variant's steps, lr and l2), the same file (rows rounded,
    the best variant a later one) and the same patched
    ``e2e_flagship.json`` row."""
    e2e = json.dumps({"lhuc_noiv": {"old": 1}, "keep": [1, 2]})
    ref_setup, port_setup = _setups()
    ref = _reference("lhuc_regularized")
    bufs = _fake_fs(ref, {"docs/e2e_flagship.json": e2e})
    jw, jl, jg = _World({}, torch_side=False), [], []
    _jax_common(monkeypatch, jw, ref, jg)
    monkeypatch.setattr(ref.flag, "build_setup", lambda: ref_setup)
    monkeypatch.setattr(ref.flag, "lhuc_adapt_and_decode",
                        _lhuc_standin(jl, False))
    monkeypatch.setattr(ref.flag, "N_TEST", N_TEST)
    ref.main()
    want = json.loads(bufs["docs/lhuc_noiv_reg.json"].getvalue())
    want_e2e = json.loads(bufs["docs/e2e_flagship.json"].getvalue())

    (tmp_path / tlr.E2E_FILE).write_text(e2e)
    tw, tl, tg = _World({}, torch_side=True), [], []
    _port_common(monkeypatch, tw, tlr, tg)
    monkeypatch.setattr(tlr, "lhuc_adapt_and_decode", _lhuc_standin(tl, True))
    res = tlr.main(["--out", str(tmp_path)], device="cpu", setup=port_setup)
    assert tw.calls == jw.calls and [c[2] for c in tw.calls] == [1000]
    assert tw.decodes == jw.decodes and tg == jg
    assert tl == jl and [c[6:] for c in tl] == [(24, 0.2, 0.0),
                                                (24, 0.2, 2.0),
                                                (12, 0.2, 0.5)]
    assert not any(c[4] for c in tl)
    got = json.loads((tmp_path / tlr.FILE).read_text())
    assert got == want and got["best_variant"] == "l2_2.0_24"
    assert res.patched
    assert json.loads((tmp_path / tlr.E2E_FILE).read_text()) == want_e2e
    assert set(got) == set(_doc("lhuc_noiv_reg.json"))


def test_lhuc_patch_is_skipped_without_the_file_and_raises_on_a_broken_one(
        tmp_path, capsys):
    """No ``e2e_flagship.json`` in --out: the patch is skipped and said so;
    one that cannot be read raises (the reference prints "skipped" for
    any exception, ``:91-92``)."""
    result = {"wer_unadapted_full": 9.0, "best_variant": "a",
              "variants": {"a": {"wer_after": 8.0}}}
    assert not tlr.patch_e2e(str(tmp_path), result)
    (tmp_path / tlr.E2E_FILE).write_text("{broken")
    with pytest.raises(json.JSONDecodeError):
        tlr.patch_e2e(str(tmp_path), result)
    (tmp_path / tlr.E2E_FILE).write_text("[1, 2]")
    with pytest.raises(TypeError):
        tlr.patch_e2e(str(tmp_path), result)
    assert tlr.best_variant({"a": {"wer_after": 1.0}, "b": {"wer_after": 1.0},
                             "c": {"wer_after": 0.5}}) == "c"
    assert tlr.best_variant({"a": {"wer_after": 1.0},
                             "b": {"wer_after": 1.0}}) == "a"


# ---- rnnlm_fair_fight ----

_SMALL_RNN = dict(embed_dim=16, hidden_dim=24, proj_dim=8)


def _nbest_lists(n_lats, vocab, n=30):
    """Deterministic n-best lists, one per lattice, each best first."""
    out = {}
    for i in range(n_lats):
        rng = np.random.RandomState(100 + i)
        hyps = [(list(rng.randint(0, vocab, rng.randint(1, 6))),
                 float(-rng.rand() * 20)) for _ in range(n)]
        out[f"lat{i}"] = sorted(hyps, key=lambda h: -h[1])
    return out


@pytest.mark.parametrize("tsucc", [False, True])
def test_fair_fight_equals_the_reference(tsucc, tmp_path, monkeypatch):
    """The reference's main and the port's on the same word world, with
    training, the HCLG, decodes, the n-best draws, the extra text, the
    RNNLM's training (the same small parameters in both, converted) and
    the lattice rescorer stood in for: the same calls, the RNNLM's config
    and its training text and held-out slice, the extra text's config and
    size, and the same file (the tg -> fg swap, the big 4-gram, the
    halves, the oracle, the sweep and the chosen weight, the
    perplexities), its lattice seconds apart."""
    import tdnnf_nas_tpu.data.synthetic as jsyn
    import tdnnf_nas_tpu.decode.lattice as jlat
    import tdnnf_nas_tpu.lm.rnnlm as jrnn

    ref_setup, port_setup = _setups(tsucc)
    port_cfg = dataclasses.asdict(trf.rnnlm_config(VOCAB))
    nbests = _nbest_lists(N_TEST, VOCAB)
    extra = [list(s) for s in _word_world(seed=5)[3][:60]]
    seen = {"jax": {}, "torch": {}}
    jcfg = jrnn.RnnLMConfig(vocab_size=VOCAB, tdnn_splice=True, **_SMALL_RNN)
    jparams = jrnn.init_rnnlm(jcfg, jax.random.PRNGKey(4))
    tparams = convert.rnnlm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")

    def decode(side, world):
        def run(bundle, cfg, st, g, utts, **kw):
            kw["ivectors"] = np.stack(kw["ivectors"]).tolist()
            out = world.decode(bundle, cfg, st, g, utts, **kw)
            return dict(out, wer=7.8123, lattices=[f"lat{i}" for i in
                                                   range(len(utts))])
        return run

    def corpus(side):
        def make(cfg, extra_text_sents=0):
            seen[side]["corpus"] = (dataclasses.asdict(cfg),
                                    extra_text_sents)
            return (None,) * 7 + (extra,)
        return make

    def rnnlm(side, params):
        def train(sents, cfg, **kw):
            seen[side]["rnnlm"] = ([list(map(int, s)) for s in sents],
                                   {k: v for k, v in kw.items()
                                    if k not in ("device", "heldout")},
                                   [list(map(int, s)) for s in kw["heldout"]])
            return params, 123.456
        return train

    def lattices(side):
        def rescore(lats, old_lm, scorer, **kw):
            wtt = kw.pop("word_to_token")
            seen[side]["lattice"] = (list(lats), len(old_lm.logprobs), kw,
                                     wtt(7))
            return [[(nbests[lat][-1][0], 0.0)] for lat in lats]
        return rescore

    ref = _reference("rnnlm_fair_fight")
    bufs = _fake_fs(ref, environ={"RNNLM_STEPS": "24000",
                                  "RNNLM_EXTRA_TEXT": "500000"})
    jw, jg = _World({}, torch_side=False), []
    _jax_common(monkeypatch, jw, ref, jg)
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec
    monkeypatch.setattr(jrec, "decode_corpus_words", decode("jax", jw))
    monkeypatch.setattr(ref.flag, "build_setup", lambda: ref_setup)
    monkeypatch.setattr(ref.flag, "N_TEST", N_TEST)
    monkeypatch.setattr(ref.flag, "TOPIC_SUCC", tsucc)
    monkeypatch.setattr(jlat, "lattice_nbest", lambda lat, n=10: nbests[lat])
    monkeypatch.setattr(jlat, "rescore_lattices_rnnlm", lattices("jax"))
    monkeypatch.setattr(jsyn, "make_word_corpus", corpus("jax"))
    rnn_kw = {}

    def small_cfg(**kw):
        rnn_kw.update(kw)
        return jcfg

    monkeypatch.setattr(jrnn, "RnnLMConfig", small_cfg)
    monkeypatch.setattr(jrnn, "train_rnnlm", rnnlm("jax", jparams))
    ref.main()
    want = json.loads(bufs["docs/rnnlm_rescore.json"].getvalue())
    assert set(bufs) == {"docs/rnnlm_rescore.json",
                         *(p for p in bufs if p.endswith(".pkl"))}

    tw, tg = _World({}, torch_side=True), []
    _port_common(monkeypatch, tw, trf, tg)
    monkeypatch.setattr(te2e, "decode_corpus_words", decode("torch", tw))
    monkeypatch.setattr(trf, "lattice_nbest", lambda lat, n=10: nbests[lat])
    monkeypatch.setattr(trf, "rescore_lattices_rnnlm", lattices("torch"))
    monkeypatch.setattr(trf, "make_word_corpus", corpus("torch"))
    monkeypatch.setattr(trf, "rnnlm_config", lambda v: RnnLMConfig(
        vocab_size=v, tdnn_splice=True, **_SMALL_RNN))
    monkeypatch.setattr(trf, "train_rnnlm", rnnlm("torch", tparams))
    res = trf.main(["--out", str(tmp_path), "--rnnlm-steps", "24000",
                    "--extra-text", "500000"], device="cpu",
                   setup=port_setup)
    got = json.loads((tmp_path / trf.FILE).read_text())
    assert tw.calls == jw.calls and [c[2] for c in tw.calls] == [1600]
    assert tw.decodes == jw.decodes and tg == jg
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["corpus"][1] == 500000
    assert rnn_kw == {k: v for k, v in port_cfg.items() if k in rnn_kw}
    assert rnn_kw == dict(vocab_size=VOCAB, embed_dim=1024, hidden_dim=2048,
                          proj_dim=512, tdnn_splice=True)
    steps = seen["torch"]["rnnlm"][1]
    assert steps["num_steps"] == 24000 and steps["eval_every"] == 3000
    lat = {k: v for k, v in got.pop("lattice_rescore").items()
           if not k.startswith("seconds")}
    assert lat == {k: v for k, v in want.pop("lattice_rescore").items()
                   if not k.startswith("seconds")}
    g_ppl, w_ppl = got["rnnlm"].pop("ppl_testutts"), want["rnnlm"].pop(
        "ppl_testutts")
    assert g_ppl == pytest.approx(w_ppl, abs=0.11)
    assert got == want
    assert got["corpus_variant"] == ("topic_successors" if tsucc else "base")
    assert res.nbest_seconds >= 0
    assert set(got) | {"lattice_rescore"} == set(_doc("rnnlm_rescore.json"))


def test_fair_fight_caches_only_under_cache_dir(tmp_path, monkeypatch):
    """Without --cache-dir nothing is written but the file; with it, a
    second run takes the n-best lists and the RNNLM from the cache
    (no AM step, no RNNLM step) and writes the same file."""
    _, port_setup = _setups()
    nbests = _nbest_lists(N_TEST, VOCAB)
    tw, tg = _World({}, torch_side=True), []
    _port_common(monkeypatch, tw, trf, tg)

    def decode(bundle, cfg, st, g, utts, **kw):
        return {"wer": 7.8, "hyps": [], "lattices": [
            f"lat{i}" for i in range(len(utts))]}

    cfg = RnnLMConfig(vocab_size=VOCAB, tdnn_splice=True, **_SMALL_RNN)
    trained = []

    def train(sents, c, **kw):
        trained.append(len(sents))
        return init_rnnlm(c, torch.Generator().manual_seed(0), "cpu"), 50.0

    monkeypatch.setattr(te2e, "decode_corpus_words", decode)
    monkeypatch.setattr(trf, "lattice_nbest", lambda lat, n=10: nbests[lat])
    monkeypatch.setattr(trf, "rescore_lattices_rnnlm",
                        lambda lats, *a, **k: [[([1], 0.0)]] * len(lats))
    monkeypatch.setattr(trf, "make_word_corpus",
                        lambda cfg, extra_text_sents=0: (None,) * 7 + (
                            [[1, 2]] * extra_text_sents,))
    monkeypatch.setattr(trf, "rnnlm_config", lambda v: cfg)
    monkeypatch.setattr(trf, "train_rnnlm", train)
    args = ["--rnnlm-steps", "3", "--extra-text", "20"]
    out1 = tmp_path / "a"
    trf.main(["--out", str(out1)] + args, device="cpu", setup=port_setup)
    assert os.listdir(out1) == [trf.FILE] and len(tw.calls) == 1
    cache = tmp_path / "cache"
    for i in range(2):
        trf.main(["--out", str(tmp_path / f"c{i}"), "--cache-dir",
                  str(cache)] + args, device="cpu", setup=port_setup)
    assert len(tw.calls) == 2 and len(trained) == 3 - 1
    assert sorted(os.listdir(cache)) == [
        "rnnlm_fight_nbests_v2.pkl",
        f"rnnlm_params_base_3_{trained[0]}.pkl"]
    files = [json.loads((tmp_path / d / trf.FILE).read_text())
             for d in ("c0", "c1")]
    for f in files:
        f["lattice_rescore"].pop("seconds_total")
        f["lattice_rescore"].pop("seconds_per_lattice")
    assert files[0] == files[1]


def test_fair_fight_helpers():
    """The held-out slice: every 40th sentence, at most 512, and every
    sentence equal to one of them out of the training text; the oracle
    takes each list's best hypothesis."""
    lm_all = [[i % 50, i % 7] for i in range(30000)]
    held, train = trf.held_out_split(lm_all)
    assert len(held) == 512 and held[1] == lm_all[40]
    held_set = {tuple(s) for s in held}
    assert train and not any(tuple(s) in held_set for s in train)
    refs = [[1, 2], [3]]
    nb = [[([9], 0.0), ([1, 2], -1.0)], [([3], 0.0)]]
    assert trf.oracle_wer(refs, nb) == 0.0
    assert trf.oracle_wer(refs, [[], [([3], 0.0)]]) == pytest.approx(
        200 / 3)


# ---- wer_synthetic ----

@pytest.fixture(scope="module")
def trained_ws():
    """The WER demo's model trained by the port in float32 (300 steps on
    its bundle), so that its exact n-best search stays fast."""
    sizes = tws.WerSizes(model_overrides=(("compute_dtype", "float32"),))
    cfg = tws.corpus_config()
    from tdnnf_nas_torch.data.synthetic import make_word_corpus
    from tdnnf_nas_torch.recipes.chain_recipes import (prepare_data,
                                                       train_model)

    utts, _, _, phone_seqs, tree, topo = make_word_corpus(cfg)
    bundle = prepare_data(utts, phone_seqs, tree, topo, cfg.num_phones,
                          dev_fraction=0.15)
    mc = tws.model_config(tree.num_pdfs, cfg.feat_dim,
                          sizes.model_overrides)
    state, metrics = train_model(bundle, mc, tws.trainer_config(300), 300,
                                 batch_size=16, chunk_width=20, seed=0,
                                 device="cpu")
    return sizes, state, metrics.last("objf_mmi")


def test_wer_synthetic_equals_the_reference(trained_ws, tmp_path,
                                            monkeypatch):
    """The reference's main and the port's, training stood in for by one
    port-trained float32 state (converted for JAX) and the RNNLM by the
    same initial parameters: the same configs and calls, the same
    bucketed forward, n-best, native lattices and rescorings, and the
    same file."""
    import tdnnf_nas_tpu.lm.rnnlm as jrnn
    import tdnnf_nas_tpu.models as jmodels

    sizes, state, objf = trained_ws
    calls = {"jax": [], "torch": []}
    jstate = types.SimpleNamespace(
        params=jax.tree.map(np.asarray, convert.tree_to_numpy(state.params)),
        bn_state=jax.tree.map(np.asarray,
                              convert.tree_to_numpy(state.bn_state)))
    metrics = types.SimpleNamespace(last=lambda k: objf,
                                    series={"objf_mmi": [(0, objf)]})

    def train(side, st):
        def run(bundle, cfg, tc, num_steps, **kw):
            calls[side].append(("train", cfg.to_json(), tc.to_json(),
                                num_steps, sorted((k, v) for k, v in
                                                  kw.items()
                                                  if k != "device")))
            return st, metrics
        return run

    rcfg = jrnn.RnnLMConfig(vocab_size=40, embed_dim=32, hidden_dim=64,
                            dropout=0.0)
    jparams = jrnn.init_rnnlm(rcfg, jax.random.PRNGKey(1))

    def rnnlm(side, params):
        def run(sents, cfg, **kw):
            calls[side].append(("rnnlm", dataclasses.asdict(cfg),
                                [list(map(int, s)) for s in sents],
                                sorted((k, v) for k, v in kw.items()
                                       if k != "device")))
            return params, 4.5
        return run

    ref = _reference("wer_synthetic")
    bufs = _fake_fs(ref)
    jcfg = jmodels.TdnnfModelConfig
    monkeypatch.setattr(jmodels, "TdnnfModelConfig", lambda **kw: jcfg(
        **kw).replace(compute_dtype="float32"))
    import tdnnf_nas_tpu.recipes as jrecipes

    monkeypatch.setattr(jrecipes, "train_model", train("jax", jstate))
    monkeypatch.setattr(jrnn, "train_rnnlm", rnnlm("jax", jparams))
    ref.main(300)
    want = json.loads(list(bufs.values())[0].getvalue())

    monkeypatch.setattr(tws, "train_model", train("torch", state))
    monkeypatch.setattr(tws, "train_rnnlm", rnnlm(
        "torch", convert.rnnlm_params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu")))
    res = tws.main(["--out", str(tmp_path)], device="cpu", sizes=sizes)
    got = json.loads((tmp_path / tws.FILE).read_text())
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][0][3] == 300 and calls["torch"][1][3] == [
        ("batch_size", 16), ("lr", 0.005), ("num_steps", 300)]
    assert got == want and got["num_utts"] == 24
    assert list(got) == list(_doc("wer_synthetic.json"))
    assert res.bundle.den_fsa is None


def test_wer_synthetic_rnnlm_from_jax_init_gives_the_reference(
        trained_ws, tmp_path, monkeypatch):
    """The RNNLM trained by each package from JAX's initial draw
    (``PRNGKey(0)``, the reference's), on one port-trained acoustic
    model: the same perplexity and the same file.  On its own draw the
    port's RNNLM rescoring lands elsewhere (``PERF.md`` §6)."""
    import tdnnf_nas_tpu.lm.rnnlm as jrnn
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes as jrecipes

    sizes, state, objf = trained_ws
    metrics = types.SimpleNamespace(last=lambda k: objf,
                                    series={"objf_mmi": [(0, objf)]})
    jstate = types.SimpleNamespace(
        params=jax.tree.map(np.asarray, convert.tree_to_numpy(state.params)),
        bn_state=jax.tree.map(np.asarray,
                              convert.tree_to_numpy(state.bn_state)))
    ref = _reference("wer_synthetic")
    bufs = _fake_fs(ref)
    jcfg = jmodels.TdnnfModelConfig
    monkeypatch.setattr(jmodels, "TdnnfModelConfig", lambda **kw: jcfg(
        **kw).replace(compute_dtype="float32"))
    monkeypatch.setattr(jrecipes, "train_model",
                        lambda *a, **k: (jstate, metrics))
    ref.main(300)
    want = json.loads(list(bufs.values())[0].getvalue())

    real = tws.train_rnnlm

    def from_jax_init(sents, cfg, **kw):
        jparams = jrnn.init_rnnlm(jrnn.RnnLMConfig(
            **dataclasses.asdict(cfg)), jax.random.PRNGKey(0))
        return real(sents, cfg, params=convert.rnnlm_params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"), **kw)

    monkeypatch.setattr(tws, "train_model",
                        lambda *a, **k: (state, metrics))
    monkeypatch.setattr(tws, "train_rnnlm", from_jax_init)
    tws.main(["--out", str(tmp_path)], device="cpu", sizes=sizes)
    got = json.loads((tmp_path / tws.FILE).read_text())
    assert got.pop("rnnlm_ppl") == pytest.approx(want.pop("rnnlm_ppl"),
                                                 rel=1e-4)
    assert got == want


def test_wer_synthetic_native_lattices_raise_without_the_library(
        trained_ws, tmp_path, monkeypatch):
    """Where the reference falls back to the Python lattice generator
    (``:74-75``), the port raises when the native library cannot be
    built."""
    from tdnnf_nas_torch.data import native

    sizes, state, objf = trained_ws
    monkeypatch.setattr(tws, "train_model", lambda *a, **k: (
        state, types.SimpleNamespace(last=lambda k: objf,
                                     series={"objf_mmi": [(0, objf)]})))
    monkeypatch.setattr(tws, "train_rnnlm", lambda sents, cfg, **kw: (
        init_rnnlm(cfg, torch.Generator().manual_seed(0), "cpu"), 9.0))

    def no_library():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "get_decoder_lib", no_library)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tws.main(["--out", str(tmp_path)], device="cpu", sizes=sizes)
    assert not (tmp_path / tws.FILE).exists()


# ---- one small run of each ----

@pytest.fixture(scope="module")
def small_setup():
    return te2e.build_setup(SMALL, device="cpu")


def test_lhuc_main_writes_the_reference_file(small_setup, tmp_path,
                                             monkeypatch):
    _small_decodes(monkeypatch, tlr)
    monkeypatch.setattr(tlr, "VARIANTS", tuple(
        (name, dict(kw, num_steps=n)) for (name, kw), n in zip(
            tlr.VARIANTS, (2, 2, 1))))
    res = tlr.main(["--out", str(tmp_path)], device="cpu",
                   sizes=tlr.LhucSizes(noiv_steps=2), setup=small_setup)
    got = json.loads((tmp_path / tlr.FILE).read_text())
    ref = _doc("lhuc_noiv_reg.json")
    assert set(got) == set(ref) and set(got["variants"]) == set(
        ref["variants"])
    for name, row in got["variants"].items():
        assert set(row) == set(ref["variants"][name])
        assert _rounded(row["wer_after"], 2) and row["wer_after"] >= 0
    assert got["best_variant"] in got["variants"] and not res.patched
    n_spk = got["variants"]["l2_0.5_12"]["speakers"]
    assert res.report.steps == {"noiv": 2}
    assert res.report.lhuc_steps == 5 * n_spk


def test_fair_fight_main_writes_the_reference_file(small_setup, tmp_path,
                                                   monkeypatch):
    _small_decodes(monkeypatch, te2e)
    monkeypatch.setattr(trf, "rnnlm_config", lambda v: RnnLMConfig(
        vocab_size=v, tdnn_splice=True, **_SMALL_RNN))
    res = trf.main(["--out", str(tmp_path), "--rnnlm-steps", "2",
                    "--extra-text", "30"], device="cpu",
                   sizes=trf.FairFightSizes(am_steps=2, nbest=5),
                   setup=small_setup)
    got = json.loads((tmp_path / trf.FILE).read_text())
    ref = _doc("rnnlm_rescore.json")
    assert set(got) == set(ref)
    for k in ("lm_text", "rnnlm", "sweep_dev_half", "sweep_eval_half",
              "lattice_rescore"):
        assert set(got[k]) == set(ref[k]), k
    assert got["lm_text"]["fisher_analogue_extra"] == 30
    assert got["rnnlm"]["steps"] == 2
    assert got["lattice_rescore"]["num_lattices"] == SMALL.n_test
    dev_half = got["sweep_dev_half"]
    assert dev_half[str(got["interp_weight_dev_choice"])] == min(
        dev_half.values())
    assert res.report.steps == {"am": 2}
