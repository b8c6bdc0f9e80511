"""The port's search experiments (``tools/search_sanity_planted``,
``tools/search_planted_table``, ``tools/e2e_wer_pipeline``) against the
reference scripts of the same names on the CPU: the planted corpus bit
for bit; every corpus, model, trainer and RNNLM config and each table,
run by the reference's own code and by the port's with the same
stand-ins for training, valid steps and decoding (the same alphas in
both); the WER pipeline's set-up chain against the JAX package's at a
small size; three float32 steps of a planted-table child on its blocked
den against JAX's; one small run of each tool's ``main``; the RNNLM
stage raising where the reference prints "skipped"; and the trigram of a
search-only run."""

import contextlib
import dataclasses
import importlib.util
import inspect
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tdnnf_nas_torch.data.synthetic as tsyn
import tdnnf_nas_tpu.data.synthetic as jsyn
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.recipes.chain_recipes import train_model
from tdnnf_nas_torch.tools import e2e_search as tsearch
from tdnnf_nas_torch.tools import e2e_wer_pipeline as twer
from tdnnf_nas_torch.tools import search_planted_table as tspt
from tdnnf_nas_torch.tools import search_sanity_planted as tssp

torch.set_num_threads(2)

# the corpus generators, kept before any test stands in for them
_MAKE_WORD_CORPUS = {"jax": jsyn.make_word_corpus,
                     "torch": tsyn.make_word_corpus}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the narrow model of the small runs, on top of each tool's config
NARROW = (("hidden_dim", 32), ("bottleneck_dim", 8), ("prefinal_big", 32),
          ("prefinal_small", 16))
N_TEST = 3  # test utterances of the small worlds


def _reference(name: str, **switches):
    """``scripts/<name>.py`` as a module (its imports are lazy), with its
    module switches (QUICK, HARD, SILENCE, N_TEST) set."""
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in switches.items():
        setattr(mod, k, v)
    return mod


def _files(ref) -> dict:
    """Routes the reference's ``open(path, "w")`` to buffers: {path: text}."""
    bufs = {}

    def fake_open(path, mode="r", *a, **k):
        return contextlib.nullcontext(bufs.setdefault(path, io.StringIO()))

    ref.open = fake_open
    return bufs


def _doc(name: str) -> dict:
    with open(os.path.join(REPO, "docs", name)) as f:
        return json.load(f)


class _Captured(Exception):
    pass


# ---- stand-ins for training, valid steps, decoding ----

# the keywords of train_model a call records, with their defaults (the
# same in both packages)
_TRAIN_DEFAULTS = tuple(
    (k, inspect.signature(train_model).parameters[k].default)
    for k in ("batch_size", "chunk_width", "seed", "supernet", "dev",
              "log_every", "max_phones_per_chunk"))

class _World:
    """One side's stand-ins.  ``train`` records every train_model call
    (model and trainer config, steps, keywords) and hands back the given
    alphas after an alpha update; a child's state carries its config as
    its params, so ``count_params`` counts its stride pairs; valid steps
    and decodes return fixed scores that depend on the config."""

    def __init__(self, alphas: dict, torch_side: bool):
        self.alphas = alphas
        self.torch_side = torch_side
        self.calls = []
        self.decodes = []

    def _arr(self, a):
        return torch.tensor(a) if self.torch_side else a

    def train(self, bundle, cfg, tc, n, **kw):
        self.calls.append((cfg.to_json(), tc.to_json(), n,
                           {k: kw.get(k, d) for k, d in _TRAIN_DEFAULTS},
                           kw.get("init_state") is not None))
        st = types.SimpleNamespace(params=cfg, alphas={})
        if kw.get("supernet"):
            which = "cv" if tc.train_alpha else "pretrain"
            st.alphas = {k: self._arr(v) for k, v in zip(
                ("offsets_linear", "offsets_affine"), self.alphas[which])}
        series = [(i, -0.5 + 0.001 * i) for i in range(n)]
        return st, types.SimpleNamespace(
            last=lambda k: -0.123456 - 0.001 * n,
            series={"objf_mmi": series})

    def valid_step(self, cfg, tc, den, *a, **k):
        value = -0.25 - 0.01 * sum(map(sum, cfg.stride_pairs))
        return lambda st, b: {"objf_mmi": value}

    def decode(self, bundle, cfg, st, g, utts, **kw):
        self.decodes.append((len(utts), sorted(
            (k, v) for k, v in kw.items() if k != "device")))
        return {"wer": 12.3456 + sum(map(sum, cfg.stride_pairs)),
                "hyps": [[] for _ in utts],
                "lattices": [None] * len(utts)}


def _alphas(layers: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"pretrain": (np.zeros((layers, 4), np.float32),) * 2,
            "cv": (rng.randn(layers, 4).astype(np.float32) * 2,
                   rng.randn(layers, 4).astype(np.float32) * 2)}


def _count_params(cfg):
    return sum(map(sum, cfg.stride_pairs)) + 1000


def _jax_standins(monkeypatch, world: _World):
    import tdnnf_nas_tpu.data.egs as jegs
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec
    import tdnnf_nas_tpu.train as jtrain

    monkeypatch.setattr(jrec, "train_model", world.train)
    monkeypatch.setattr(jrec, "decode_corpus_words", world.decode)
    monkeypatch.setattr(jtrain, "make_valid_step", world.valid_step)
    monkeypatch.setattr(jegs, "batch_iterator",
                        lambda *a, **k: iter([{"x": np.zeros(1)}] * 10))
    monkeypatch.setattr(jmodels, "count_params", _count_params)


def _port_standins(monkeypatch, world: _World, *mods):
    for mod in (tsearch,) + mods:
        if hasattr(mod, "train_model"):
            monkeypatch.setattr(mod, "train_model", world.train)
        if hasattr(mod, "decode_corpus_words"):
            monkeypatch.setattr(mod, "decode_corpus_words", world.decode)
    monkeypatch.setattr(tsearch, "make_valid_step", world.valid_step)
    monkeypatch.setattr(tsearch, "den_on_device", lambda *a: None)
    monkeypatch.setattr(tsearch, "batch_iterator",
                        lambda *a, **k: iter([{"x": np.zeros(1)}] * 10))
    monkeypatch.setattr(tsearch.convert, "batch_to_torch", lambda b, d: b)
    monkeypatch.setattr(tsearch, "count_params",
                        lambda params: _count_params(params))


def _cv_capped(jax_calls, port_calls, bundle, darts_cfg):
    """The calls, the reference's cv-update batch of 48 replaced by the
    port's: min(48, the dev split's supernet chunks), which a small world
    falls short of (the reference's train_model raises there)."""
    n_dev = len(bundle.egs(None, chunk_width=24, dev=True,
                           supernet_cfg=darts_cfg))
    out = []
    for call in jax_calls:
        kw = dict(call[3])
        if kw["supernet"] and kw["dev"]:
            assert kw["batch_size"] == 48
            kw["batch_size"] = min(48, n_dev)
        out.append(call[:3] + (kw,) + call[4:])
    assert [c[3]["batch_size"] for c in port_calls] == [
        c[3]["batch_size"] for c in out]
    return out


def _darts(mc):
    from tdnnf_nas_torch.models import DartsModelConfig

    return DartsModelConfig(base=mc, search_offsets=True, max_stride=3)


def _drop_seconds(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "seconds"}


# ---- the sanity check ----

def test_planted_corpus_equals_the_reference_bit_for_bit():
    ref = _reference("search_sanity_planted")
    j_utts, j_phones, j_tree, j_topo = ref.make_planted_corpus()
    t_utts, t_phones, t_tree, t_topo = tssp.make_planted_corpus()
    assert tssp.K_LAG == ref.K_LAG == 6
    assert len(t_utts) == len(j_utts) == 160
    assert t_phones == j_phones
    for a, b in zip(t_utts, j_utts):
        assert a.feats.dtype == b.feats.dtype == np.float32
        np.testing.assert_array_equal(a.feats, b.feats)
        np.testing.assert_array_equal(a.pdf_align, b.pdf_align)
        assert (a.phones, a.begins, a.ends) == (b.phones, b.begins, b.ends)
    assert (t_tree.num_pdfs, t_topo.num_phones) == (j_tree.num_pdfs,
                                                    j_topo.num_phones) \
        == (16, 8)


@pytest.mark.parametrize("seed", [0, 1])
def test_sanity_run_equals_the_reference_on_the_same_alphas(seed,
                                                             monkeypatch):
    """The reference's main and the port's, training, valid steps and
    batches stood in for, the cv-update handing back the same alphas: the
    same train_model calls (configs, steps, batch, chunk, seeds, splits),
    the same top-1 and no-lookahead children, and the same file (its
    entropies, softmax, reach and gap, rounded alike)."""
    alphas = _alphas(1, seed)
    ref = _reference("search_sanity_planted")
    bufs = _files(ref)
    jw = _World(alphas, torch_side=False)
    _jax_standins(monkeypatch, jw)
    ref.main(5, 6, 7)
    want = json.loads(bufs["docs/search_sanity.json"].getvalue())

    tw = _World(alphas, torch_side=True)
    _port_standins(monkeypatch, tw, tssp)
    res = tssp.main(5, 6, 7, device="cpu")
    assert tw.calls == jw.calls
    assert [c[2] for c in tw.calls] == [5, 6, 7, 7]
    assert _drop_seconds(res.report.search) == _drop_seconds(want)
    assert res.report.valid_batches == 2 * tssp.VALID_BATCHES
    assert set(want) == set(_doc("search_sanity.json"))


def test_sanity_cv_update_follows_jax():
    """The sanity check's cv-update (softmax, alphas only, theta and BN
    frozen, ``alpha_lr_scale`` 30, batches of 16 from the dev split) run
    by each package's ``train_model`` from one supernet state with seeded
    output layers: objf within 5e-4 at each of 20 steps and the alphas
    within 1e-4 after (the pretraining's uniform draws differ between the
    packages' streams; this stage has none)."""
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec
    import tdnnf_nas_tpu.train as jtrain
    from tdnnf_nas_torch.models import DartsModelConfig, SearchMode
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    from tdnnf_nas_torch.train import OptimizerConfig, TrainerConfig

    ref = _reference("search_sanity_planted")
    utts, phones, tree, topo = ref.make_planted_corpus()
    jb = jrec.prepare_data(utts, phones, tree, topo, 8, dev_fraction=0.12)
    t_utts, t_phones, t_tree, t_topo = tssp.make_planted_corpus()
    tb = prepare_data(t_utts, t_phones, t_tree, t_topo, 8, dev_fraction=0.12)
    base = tssp.model_config(16)
    jdarts = jmodels.DartsModelConfig(
        base=jmodels.TdnnfModelConfig(**dataclasses.asdict(base)),
        search_offsets=True, max_stride=3)
    tdarts = DartsModelConfig(base=base, search_offsets=True, max_stride=3)
    kw = dict(train_theta=False, train_alpha=True, bn_frozen=True)
    opt = dict(tssp.OPT, num_steps=800, alpha_lr_scale=30.0)
    jtc = jtrain.TrainerConfig(search_mode=jmodels.SearchMode.SOFTMAX,
                               optimizer=jtrain.OptimizerConfig(**opt), **kw)
    ttc = TrainerConfig(search_mode=SearchMode.SOFTMAX,
                        optimizer=OptimizerConfig(**opt), **kw)
    assert ttc.to_json() == jtc.to_json()
    jst = jtrain.init_train_state(jdarts, jtc, jax.random.PRNGKey(2),
                                  supernet=True)
    rng = np.random.RandomState(2)
    params = dict(jst.params)
    for head in ("chain", "xent"):
        out = params[f"output_{head}"]
        params[f"output_{head}"] = dict(out, w=jnp.asarray(
            rng.randn(*out["w"].shape).astype(np.float32) * 0.1))
    jst = dataclasses.replace(jst, params=params)
    tst = convert.supernet_state_from_numpy(
        *(jax.tree.map(np.asarray, t) for t in (
            jst.params, jst.alphas, jst.bn_state, jst.opt_state,
            jst.alpha_opt_state)), int(jst.step), device="cpu")
    run = dict(batch_size=tssp.BATCH, chunk_width=tssp.CHUNK, seed=1,
               supernet=True, dev=True)
    jst, jlog = jrec.train_model(jb, jdarts, jtc, 20, init_state=jst, **run)
    tst, tlog = train_model(tb, tdarts, ttc, 20, init_state=tst,
                            device="cpu", prefetch=0, **run)
    jo = [v for _, v in jlog.series["objf_mmi"]]
    to = [v for _, v in tlog.series["objf_mmi"]]
    assert len(to) == len(jo) == 20
    assert max(abs(a - b) for a, b in zip(jo, to)) < 5e-4, (jo, to)
    for name, a in tst.alphas.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(jst.alphas[name]),
                                   rtol=0, atol=1e-4, err_msg=name)
        assert float(np.abs(a.numpy()).max()) > 1e-3, name


# ---- the planted table ----

def _table_world(pkg: str, cfg_fields: dict, num_utts: int = 40):
    """A small corpus built by one package's make_word_corpus from a
    tool's config with ``num_utts`` utterances."""
    syn = {"jax": jsyn, "torch": tsyn}[pkg]
    return _MAKE_WORD_CORPUS[pkg](syn.WordCorpusConfig(
        **dict(cfg_fields, num_utts=num_utts)))


@pytest.mark.parametrize("quick", [True, False])
def test_planted_table_equals_the_reference_on_the_same_alphas(
        quick, monkeypatch):
    """The reference's main (QUICK set on the module) and the port's
    ``main(quick)`` on a 40-utterance corpus of the preset's config: the
    corpus config each hands make_word_corpus, prepare_data's keywords,
    every train_model call, each decode's keywords and the whole file but
    its seconds (the affine softmax, the random arch of RandomState(123),
    the rows' strides, reach, params, objfs and WERs, the diagnosis
    verbatim)."""
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    alphas = _alphas(5, 3)
    seen = {"jax": {}, "torch": {}}

    def corpus(side, pkg):
        def make(cfg):
            seen[side]["corpus"] = dataclasses.asdict(cfg)
            return _table_world(pkg, dataclasses.asdict(cfg))
        return make

    def prep(side, fn):
        def wrapped(*a, **k):
            seen[side]["prepare_data"] = k
            return fn(*a, **k)
        return wrapped

    ref = _reference("search_planted_table", QUICK=quick, N_TEST=N_TEST)
    bufs = _files(ref)
    jw = _World(alphas, torch_side=False)
    _jax_standins(monkeypatch, jw)
    monkeypatch.setattr(jsyn, "make_word_corpus", corpus("jax", "jax"))
    monkeypatch.setattr(jrec, "prepare_data",
                        prep("jax", jrec.prepare_data))
    ref.main()
    want = json.loads(bufs["docs/search_table.json"].getvalue())

    tw = _World(alphas, torch_side=True)
    _port_standins(monkeypatch, tw, tspt)
    monkeypatch.setattr(tspt, "make_word_corpus", corpus("torch", "torch"))
    monkeypatch.setattr(tspt, "prepare_data",
                        prep("torch", tspt.prepare_data))
    sizes = dataclasses.replace(tspt.TableSizes.preset(quick), n_test=N_TEST)
    res = tspt.main(quick=quick, device="cpu", sizes=sizes)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["corpus"]["num_utts"] == (240 if quick else 720)
    assert tw.calls == _cv_capped(jw.calls, tw.calls, res.setup.bundle,
                                  _darts(res.model_cfg))
    assert [c[2] for c in tw.calls] == list(sizes.steps[:2]) \
        + [sizes.child_steps] * 3
    assert sizes.steps == ((120, 200, 150) if quick else (500, 700, 700))
    assert tw.decodes == jw.decodes
    got = res.report.search
    assert _drop_seconds(got) == _drop_seconds(want)
    assert got["diagnosis_round3"] == _doc("search_table.json")[
        "diagnosis_round3"]
    assert set(got) == set(_doc("search_table.json"))
    assert res.report.valid_batches == 3 * tspt.VALID_BATCHES
    assert tspt.N_TEST == _reference("search_planted_table").N_TEST


# ---- the WER pipeline ----

@pytest.mark.parametrize("variant", list(twer.VARIANTS))
def test_wer_pipeline_equals_the_reference(variant, monkeypatch):
    """The reference's ``run_base`` then ``run_search`` (HARD / SILENCE set
    on the module) and the port's ``main all --variant``, the GMM ladder,
    training, decoding and the RNNLM stood in for: the corpus and ladder
    configs, the
    tree and prepare_data keywords, the HCLG's silence arguments, every
    train_model call, the RNNLM's config, steps and text, the decodes, and
    both files, on an 80-utterance corpus of the variant's config; the full
    sizes are the reference's."""
    import tdnnf_nas_tpu.decode.graph_sparse as jgs
    import tdnnf_nas_tpu.decode.lattice as jlat
    import tdnnf_nas_tpu.lm.rnnlm as jrnn
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    alphas = _alphas(5, 4)
    seen = {"jax": {}, "torch": {}}

    def corpus(side, pkg):
        def make(cfg):
            seen[side]["corpus"] = dataclasses.asdict(cfg)
            return _table_world(pkg, dataclasses.asdict(cfg), 80)
        return make

    def ladder(side):
        def boot(train, phones, num_phones, speakers=None, ladder_cfg=None,
                 device=None):
            seen[side]["ladder"] = (dataclasses.asdict(ladder_cfg),
                                    num_phones, len(train), len(speakers))
            return train, types.SimpleNamespace(fmllr_gain=1.25)
        return boot

    def wrap(side, key, fn):
        def wrapped(*a, **k):
            seen[side].setdefault(key, []).append(k)
            return fn(*a, **k)
        return wrapped

    def rnnlm(side):
        def train(sents, cfg, num_steps=0, batch_size=0, seed=0, device=None):
            seen[side]["rnnlm"] = (dataclasses.asdict(cfg), num_steps,
                                   batch_size, seed, [list(s) for s in sents])
            return None, 1.0
        return train

    best = [([1, 2], 0.0)]
    hard, sil = variant == "hard", variant == "sil"
    ref = _reference("e2e_wer_pipeline", HARD=hard, SILENCE=sil,
                     N_TEST=N_TEST)
    bufs = _files(ref)
    jw = _World(alphas, torch_side=False)
    _jax_standins(monkeypatch, jw)
    monkeypatch.setattr(jsyn, "make_word_corpus", corpus("jax", "jax"))
    monkeypatch.setattr(jrec, "bootstrap_alignments_gmm", ladder("jax"))
    monkeypatch.setattr(jrec, "prepare_data",
                        wrap("jax", "prepare_data", jrec.prepare_data))
    monkeypatch.setattr(jgs, "build_hclg_sparse",
                        wrap("jax", "hclg", jgs.build_hclg_sparse))
    monkeypatch.setattr(jlat, "rescore_lattice", lambda *a, **k: best)
    monkeypatch.setattr(jlat, "rescore_lattice_rnnlm", lambda *a, **k: best)
    monkeypatch.setattr(jrnn, "train_rnnlm", rnnlm("jax"))
    monkeypatch.setattr(jrnn, "RnnLMScorer", lambda *a: None)
    ref.run_search(ref.run_base())
    names = twer.file_names(variant)
    want = {k: json.loads(bufs[f"docs/{names[k]}"].getvalue())
            for k in ("e2e", "search")}
    assert len(bufs) == 2

    tw = _World(alphas, torch_side=True)
    _port_standins(monkeypatch, tw, twer, tspt)
    monkeypatch.setattr(twer, "make_word_corpus", corpus("torch", "torch"))
    monkeypatch.setattr(twer, "bootstrap_alignments_gmm", ladder("torch"))
    monkeypatch.setattr(twer, "prepare_data",
                        wrap("torch", "prepare_data", twer.prepare_data))
    monkeypatch.setattr(twer, "build_hclg_sparse",
                        wrap("torch", "hclg", twer.build_hclg_sparse))
    monkeypatch.setattr(twer, "rescore_lattice", lambda *a, **k: best)
    monkeypatch.setattr(twer, "rescore_lattices_rnnlm",
                        lambda lats, *a, **k: [best] * len(lats))
    monkeypatch.setattr(twer, "train_rnnlm", rnnlm("torch"))
    monkeypatch.setattr(twer, "RnnLMScorer", lambda *a: None)
    sizes = dataclasses.replace(twer.E2eWerSizes.full(), n_test=N_TEST)
    res = twer.main(["all", "--variant", variant, "--out", ""],
                    device="cpu", sizes=sizes)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["corpus"]["num_utts"] == 720
    assert seen["torch"]["hclg"][0]["sil_prob"] == (0.3 if sil else 0.0)
    assert tw.calls == _cv_capped(jw.calls, tw.calls, res.setup.bundle,
                                  _darts(res.base.model_cfg))
    assert tw.decodes == jw.decodes
    assert res.report.e2e == want["e2e"]
    assert res.report.search == want["search"]
    full = twer.E2eWerSizes.full()
    assert [c[2] for c in tw.calls] == [full.train_steps, full.pretrain_steps,
                                        full.cv_steps] + [full.child_steps] * 3
    assert seen["torch"]["rnnlm"][1:4] == (full.rnnlm_steps,
                                           full.rnnlm_batch, 0)
    rl = seen["torch"]["rnnlm"][0]
    assert (rl["embed_dim"], rl["hidden_dim"], rl["proj_dim"]) == (
        full.rnnlm_embed, full.rnnlm_hidden, full.rnnlm_proj)
    assert full.n_test == _reference("e2e_wer_pipeline").N_TEST
    assert set(want["e2e"]) == set(_doc("e2e_wer.json"))
    assert set(want["search"]) == set(_doc("search_table_e2e_hard.json"))


def test_the_search_only_trigram_takes_every_transcript(monkeypatch):
    """``search`` alone builds its trigram from all the training
    transcripts in both (the reference's :242-243, kept), where ``all``
    hands over run_base's trigram of half of them."""
    import tdnnf_nas_tpu.lm.ngram as jngram

    word_seqs = [[i % 7, (i * 3) % 7] for i in range(20)]
    seen = {}

    def capture(side):
        def est(text, order=3):
            seen[side] = (text, order)
            raise _Captured
        return est

    ref = _reference("e2e_wer_pipeline", N_TEST=N_TEST)
    cfg = types.SimpleNamespace(vocab_size=7, silence_phone=-1)
    monkeypatch.setattr(ref, "build_setup", lambda: (
        cfg, None, None, word_seqs, None, None, None, None, None))
    monkeypatch.setattr(jngram, "estimate_ngram_lm", capture("jax"))
    with pytest.raises(_Captured):
        ref.run_search(None)
    monkeypatch.setattr(twer, "estimate_ngram_lm", capture("torch"))
    setup = types.SimpleNamespace(
        cfg=cfg, word_seqs=word_seqs,
        sizes=dataclasses.replace(twer.E2eWerSizes.full(), n_test=N_TEST))
    with pytest.raises(_Captured):
        twer.run_search(setup, None, device="cpu")
    assert seen["torch"] == seen["jax"]
    assert len(seen["torch"][0]) == 20 - N_TEST


def test_full_sizes_and_file_names():
    full = twer.E2eWerSizes.full()
    assert (full.num_utts, full.train_steps, full.pretrain_steps,
            full.cv_steps, full.child_steps) == (720, 900, 500, 400, 700)
    assert twer.file_names("default") == {
        "e2e": "e2e_wer.json", "search": "search_table_e2e.json"}
    assert twer.file_names("hard") == {
        "e2e": "e2e_wer_hard.json", "search": "search_table_e2e_hard.json"}
    assert twer.file_names("sil") == {
        "e2e": "e2e_wer_sil.json", "search": "search_table_e2e.json"}
    with pytest.raises(ValueError, match="variant"):
        twer.corpus_config("loud", full)


# ---- the set-up chain against JAX, at a small size ----

SMALL = dataclasses.replace(
    twer.E2eWerSizes.full(), n_test=N_TEST, num_utts=60, train_steps=2,
    rnnlm_embed=16, rnnlm_hidden=32, rnnlm_proj=16, rnnlm_steps=2,
    pretrain_steps=2, cv_steps=2, child_steps=2, model_overrides=NARROW)


@pytest.fixture(scope="module")
def sil_chain():
    """build_setup of the ``sil`` variant at SMALL on the port, and the
    reference's chain of the same functions in the JAX package."""
    import tdnnf_nas_tpu.gmm as jgmm
    import tdnnf_nas_tpu.graphs as jgraphs
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    port = twer.build_setup("sil", SMALL, device="cpu")
    cfg = twer.corpus_config("sil", SMALL)
    utts, prons, word_seqs, _, _, topo = jsyn.make_word_corpus(
        jsyn.WordCorpusConfig(**dataclasses.asdict(cfg)))
    train = utts[N_TEST:]
    phones = [u.phones for u in train]
    raw = [list(u.begins) for u in train]
    lc = twer.ladder_config()
    _, ladder = jrec.bootstrap_alignments_gmm(
        train, phones, cfg.num_phones, speakers=[u.speaker for u in train],
        ladder_cfg=jgmm.GmmLadderConfig(
            mono=jgmm.MonoHmmConfig(**dataclasses.asdict(lc.mono)),
            **{k: v for k, v in dataclasses.asdict(lc).items()
               if k != "mono"}))
    stats = jgraphs.accumulate_triphone_stats(
        [u.feats for u in train], phones, [u.begins for u in train],
        cfg.num_phones, cfg.frame_subsampling_factor)
    tree = jgraphs.build_clustered_triphone_tree(stats, num_leaves=400)
    bundle = jrec.prepare_data(train, phones, tree, topo, cfg.num_phones,
                               dev_fraction=0.08, phone_lm_order=4,
                               num_extra_lm_states=500)
    return port, dict(train=train, raw=raw, tree=tree, bundle=bundle,
                      prons=prons, word_seqs=word_seqs, topo=topo,
                      ladder=ladder, cfg=cfg)


def test_setup_chain_equals_jax(sil_chain):
    """The ladder's alignments (moved from the generator's), its fMLLR
    gain, the tree and the composed den in its blocked form."""
    from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph

    p, j = sil_chain
    assert p.word_seqs == j["word_seqs"] and p.prons == j["prons"]
    assert [u.begins for u in p.train] == [u.begins for u in j["train"]]
    assert [u.ends for u in p.train] == [u.ends for u in j["train"]]
    assert [u.begins for u in j["train"]] != j["raw"]
    assert p.fmllr_gain == pytest.approx(j["ladder"].fmllr_gain, abs=1e-3)
    assert p.tree.num_pdfs == j["tree"].num_pdfs
    np.testing.assert_array_equal(p.tree._fwd_table, j["tree"]._fwd_table)
    assert p.bundle.den_fsa.num_states == j["bundle"].den_fsa.num_states
    assert isinstance(p.bundle.den_arrays, BlockedDenGraph)
    assert type(j["bundle"].den_arrays).__name__ == "BlockedDenGraph"
    assert len(p.bundle.dev_utts) == len(j["bundle"].dev_utts)


@pytest.mark.parametrize("silence", [True, False])
def test_hclg_equals_jax(sil_chain, silence):
    """The trigram HCLG on the silence corpus, with optional silence and
    without: states and arcs."""
    from tdnnf_nas_tpu.decode.graph_sparse import build_hclg_sparse
    from tdnnf_nas_tpu.decode.wfst import Lexicon
    from tdnnf_nas_tpu.lm.ngram import estimate_ngram_lm

    p, j = sil_chain
    setup = p if silence else dataclasses.replace(p, variant="default")
    sym = twer.word_symbols(p.cfg)
    text = [[sym[w] for w in ws] for ws in p.word_seqs[N_TEST:]]
    g = twer.build_hclg(setup, twer.estimate_ngram_lm(text, order=3), sym)
    jg = build_hclg_sparse(Lexicon(j["prons"]),
                           estimate_ngram_lm(text, order=3), sym, j["topo"],
                           j["tree"], sil_phone=j["cfg"].silence_phone,
                           sil_prob=0.3 if silence else 0.0)
    assert (g.num_states, g.num_arcs) == (jg.num_states, jg.num_arcs)


# ---- three float32 child steps on the planted table's blocked den ----

def test_planted_child_three_f32_steps_match_jax():
    """The manual child of the planted table, in float32, on the blocked
    den of a 40-utterance planted corpus: JAX's initial params through
    ``convert``, three steps on the same batches of 48 x 24 frames, objf
    within the reference's multi-step bar of 5e-4
    (``__graft_entry__.py:119``)."""
    import tdnnf_nas_tpu.data.egs as jegs
    import tdnnf_nas_tpu.graphs as jgraphs
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec
    import tdnnf_nas_tpu.train as jtrain
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph
    from tdnnf_nas_torch.train import make_train_step

    cfg = tspt.corpus_config(40)
    port = tspt.build_setup(cfg, N_TEST)
    utts, _, _, _, _, topo = _table_world("jax", dataclasses.asdict(cfg))
    train = utts[N_TEST:]
    phones = [u.phones for u in train]
    stats = jgraphs.accumulate_triphone_stats(
        [u.feats for u in train], phones, [u.begins for u in train], 30, 3)
    tree = jgraphs.build_clustered_triphone_tree(stats, num_leaves=400)
    jb = jrec.prepare_data(train, phones, tree, topo, 30, dev_fraction=0.08,
                           phone_lm_order=4, num_extra_lm_states=500)
    assert port.bundle.den_fsa.num_states == jb.den_fsa.num_states
    mc = tspt.model_config(tree.num_pdfs, cfg.feat_dim,
                           (("compute_dtype", "float32"),))
    jmc = jmodels.TdnnfModelConfig(**dataclasses.asdict(mc))
    opt = dict(tspt.BASE_OPT, num_steps=150)
    jtc = jtrain.TrainerConfig(
        objective=jtrain.ChainObjectiveConfig(),
        optimizer=jtrain.OptimizerConfig(**opt))
    ttc = tsearch.TrainerConfig(optimizer=tsearch.OptimizerConfig(**opt))
    assert ttc.to_json() == jtc.to_json()
    it = jegs.batch_iterator(jb.egs(jmc, chunk_width=24), 48,
                             np.random.RandomState(7))
    jbatches = [next(it) for _ in range(3)]
    t_chunks = port.bundle.egs(mc, chunk_width=24)
    it = tsearch.batch_iterator(t_chunks, 48, np.random.RandomState(7))
    tbatches = [next(it) for _ in range(3)]
    for a, b in zip(jbatches, tbatches):
        np.testing.assert_array_equal(a["feats"], b["feats"])
    jst = jtrain.init_train_state(jmc, jtc, jax.random.PRNGKey(0))
    jstep = jtrain.make_train_step(jmc, jtc, jb.den_arrays, donate=False)
    tst = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jst.params),
        jax.tree.map(np.asarray, jst.bn_state),
        jax.tree.map(np.asarray, jst.opt_state), int(jst.step),
        device="cpu")
    tstep = make_train_step(mc, ttc, BlockedDenGraph.from_host(
        port.bundle.den_arrays, "cpu"))
    jtraj, ttraj = [], []
    for jbatch, tbatch in zip(jbatches, tbatches):
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, jbatch),
                        jax.random.PRNGKey(1))
        tst, tm = tstep(tst, convert.batch_to_torch(tbatch, device="cpu"))
        jtraj.append(float(jm["objf_mmi"]))
        ttraj.append(float(tm["objf_mmi"]))
    assert all(np.isfinite(ttraj)), ttraj
    delta = max(abs(a - b) for a, b in zip(jtraj, ttraj))
    assert delta < 5e-4, (delta, jtraj, ttraj)


# ---- one small run of each tool ----

def _small_decodes(monkeypatch, *mods):
    """Narrower beams for the untrained models of the small runs, whose
    lattices would otherwise run to hundreds of thousands of arcs."""
    from tdnnf_nas_torch.recipes.chain_recipes import decode_corpus_words

    def small(*a, **k):
        k.update(beam=6.0, lattice_beam=2.0, max_active=500)
        return decode_corpus_words(*a, **k)

    for mod in mods:
        monkeypatch.setattr(mod, "decode_corpus_words", small)


def _rounded(v, places):
    return v == round(v, places)


def test_sanity_main_writes_the_reference_file(tmp_path):
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays

    res = tssp.main(3, 2, 2, out=str(tmp_path), device="cpu")
    with open(tmp_path / tssp.FILE) as f:
        got = json.load(f)
    ref = _doc("search_sanity.json")
    assert set(got) == set(ref)
    assert set(got["child_table"]) == set(ref["child_table"])
    for k in ("alpha_entropy_after_pretrain", "alpha_entropy_after_cvupdate"):
        assert set(got[k]) == set(ref[k])
        assert all(_rounded(v, 3) for v in got[k].values())
    for row in got["child_table"].values():
        assert set(row) == {"pairs", "train_objf", "dev_objf"}
        assert len(row["pairs"]) == 1
        assert _rounded(row["train_objf"], 4) and np.isfinite(row["dev_objf"])
    t = got["child_table"]
    assert got["dev_objf_gap"] == round(t["searched_top1"]["dev_objf"]
                                        - t["no_lookahead"]["dev_objf"], 4)
    assert sum(got["affine_softmax"]) == pytest.approx(1.0, abs=1e-3)
    assert res.report.steps == {"supernet": 3, "cv": 2,
                                "child_searched_top1": 2,
                                "child_no_lookahead": 2}
    assert res.report.valid_batches == 8
    assert isinstance(res.bundle.den_arrays, DenGraphArrays)
    assert res.bundle.den_fsa is None and res.bundle.den.num_states == 16


def test_table_main_writes_the_reference_file(tmp_path, monkeypatch):
    _small_decodes(monkeypatch, tspt)
    sizes = tspt.TableSizes(num_utts=50, n_test=N_TEST, pretrain_steps=2,
                            cv_steps=2, child_steps=3, n_decode=N_TEST - 1,
                            model_overrides=NARROW)
    res = tspt.main(quick=True, out=str(tmp_path), device="cpu", sizes=sizes)
    with open(tmp_path / tspt.FILE) as f:
        got = json.load(f)
    ref = _doc("search_table.json")
    assert set(got) == set(ref) and set(got["corpus"]) == set(ref["corpus"])
    assert set(got["table"]) == set(ref["table"])
    row_keys = set(ref["table"]["manual_baseline"])
    for row in got["table"].values():
        assert set(row) == row_keys and len(row["strides"]) == 5
        assert row["lookahead_reach"] == 3 + sum(a for _, a in row["strides"])
        assert _rounded(row["wer"], 2) and row["wer"] >= 0
        assert _rounded(row["dev_objf"], 4) and np.isfinite(row["dev_objf"])
    assert all(_rounded(x, 3) for r in got["affine_softmax"] for x in r)
    assert got["corpus"]["test_utts"] == N_TEST - 1
    assert got["diagnosis_round3"] == ref["diagnosis_round3"]
    assert res.report.steps == {"supernet": 2, "cv": 2,
                                **{f"child_{k}": 3 for k in got["table"]}}
    assert res.report.valid_batches == 3 * tspt.VALID_BATCHES


def test_wer_main_all_sil(sil_chain, tmp_path, monkeypatch):
    """``main all --variant sil`` at SMALL (its set-up is the chain
    fixture's): both files with the reference's keys and rounding, the
    steps and valid batches counted, and "all" decoding the search table
    on run_base's HCLG (no HCLG of its own)."""
    _small_decodes(monkeypatch, twer)
    monkeypatch.setattr(twer, "build_setup", lambda *a, **k: sil_chain[0])
    res = twer.main(["all", "--variant", "sil", "--out", str(tmp_path)],
                    device="cpu", sizes=SMALL)
    names = twer.file_names("sil")
    with open(tmp_path / names["e2e"]) as f:
        e2e = json.load(f)
    with open(tmp_path / names["search"]) as f:
        search = json.load(f)
    ref_e2e, ref_s = _doc("e2e_wer.json"), _doc("search_table_e2e_hard.json")
    assert set(e2e) == set(ref_e2e)
    assert set(e2e["corpus"]) == set(ref_e2e["corpus"])
    assert e2e["silence"] is True and e2e["corpus"]["phones"] == 31
    for k in ("wer_first_pass_tg", "wer_4gram_rescore", "wer_rnnlm_rescore"):
        assert _rounded(e2e[k], 2) and e2e[k] >= 0
    assert _rounded(e2e["train_objf_mmi"], 4)
    assert e2e["hclg_states"] == res.base.g.num_states
    assert set(search) == set(ref_s) and set(search["table"]) == set(
        ref_s["table"])
    for row in search["table"].values():
        assert set(row) == set(ref_s["table"]["manual_baseline"])
        assert len(row["strides"]) == 5
    assert res.report.steps == {"train": 2, "supernet": 2, "cv": 2,
                                **{f"child_{k}": 2 for k in search["table"]}}
    assert res.report.valid_batches == 12
    assert "6 HCLG" not in res.report.seconds


def test_the_rnnlm_stage_raises(sil_chain, monkeypatch, capsys):
    """Where the reference prints "RNNLM rescore skipped" (its ``except
    Exception`` at :196-197), the port raises; run_base's first-pass
    trigram is built on half the transcripts and the 4-gram on all."""
    _small_decodes(monkeypatch, twer)
    texts = []

    def est(text, order=3):
        texts.append((len(text), order))
        return twer.estimate_ngram_lm.__wrapped__(text, order=order)

    est.__wrapped__ = twer.estimate_ngram_lm
    monkeypatch.setattr(twer, "estimate_ngram_lm", est)

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(twer, "train_rnnlm", boom)
    with pytest.raises(RuntimeError, match="boom"):
        twer.run_base(sil_chain[0], device="cpu")
    assert "skipped" not in capsys.readouterr().out
    n = len(sil_chain[0].word_seqs) - N_TEST
    assert texts == [(n // 2, 3), (n, 4)]
