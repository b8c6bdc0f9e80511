"""The decode slice as a whole against the JAX package (CPU): the batched
forward of whole utterances (``forward_corpus``), then the word decode
with lattices and WER (``decode_corpus_words``), the phone decode
(``decode_corpus``) and forced alignment (``align_corpus``), each
package given the same trained state."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnnf_nas_tpu.data import synthetic as jsyn
from tdnnf_nas_tpu.decode import align as jalign
from tdnnf_nas_tpu.decode import graph_sparse as jgs
from tdnnf_nas_tpu.decode import wfst as jwfst
from tdnnf_nas_tpu.lm import ngram as jng
from tdnnf_nas_tpu.models import tdnnf as jmodel
from tdnnf_nas_tpu.recipes import chain_recipes as jrec
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.data import synthetic as tsyn
from tdnnf_nas_torch.decode import align as talign
from tdnnf_nas_torch.decode import graph_sparse as tgs
from tdnnf_nas_torch.decode import lattice as tlat
from tdnnf_nas_torch.decode import wfst as twfst
from tdnnf_nas_torch.lm import ngram as tng
from tdnnf_nas_torch.models import tdnnf as tmodel
from tdnnf_nas_torch.recipes import chain_recipes as trec
from tdnnf_nas_torch.train import OptimizerConfig, TrainerConfig

torch.set_num_threads(1)


def _state(params, bn, jax_side: bool):
    """What the forward needs of a TrainState: params and bn_state."""
    if jax_side:
        return types.SimpleNamespace(params=jax.tree.map(jnp.asarray, params),
                                     bn_state=jax.tree.map(jnp.asarray, bn))
    return types.SimpleNamespace(
        params=convert.tree_to_torch(params, device="cpu"),
        bn_state=convert.tree_to_torch(bn, device="cpu"))


@pytest.mark.parametrize("ivectors", ["given", "zeros"])
def test_forward_corpus_matches_jax(ivectors):
    """Each utterance's [T_out, P] output within rtol/atol 1e-4 in float32:
    9 utterances over 3 output-length buckets, batches of 4, so that two
    tail groups are padded."""
    kw = dict(feat_dim=16, ivector_dim=6, hidden_dim=32, bottleneck_dim=8,
              time_strides=(1, 1, 0, 3), num_pdfs=19, prefinal_big=32,
              prefinal_small=16, compute_dtype="float32")
    jcfg, tcfg = jmodel.TdnnfModelConfig(**kw), tmodel.TdnnfModelConfig(**kw)
    params, bn = jmodel.init_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    bn = jax.tree.map(np.asarray, bn)
    rng = np.random.RandomState(4)
    params["output_chain"]["w"] = rng.randn(
        *params["output_chain"]["w"].shape).astype(np.float32) * 0.1
    utts = tsyn.make_word_corpus(tsyn.WordCorpusConfig(
        num_utts=9, feat_dim=16, min_words=1, max_words=7, seed=2))[0]
    iv = (list(rng.randn(len(utts), 6).astype(np.float32))
          if ivectors == "given" else None)
    common = dict(bucket=16, batch_size=4, ivectors=iv)
    jo = jrec.forward_corpus(None, jcfg, _state(params, bn, True), utts,
                             **common)
    to = trec.forward_corpus(None, tcfg, _state(params, bn, False), utts,
                             device="cpu", **common)
    t_outs = [len(u.pdf_align) for u in utts]
    assert len({(t + 15) // 16 for t in t_outs}) >= 2
    for t_out, a, b in zip(t_outs, to, jo):
        assert a.dtype == np.float32 and a.shape == (t_out, 19)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)


_CORPUS = dict(vocab_size=14, num_phones=8, feat_dim=16, num_utts=48,
               min_words=2, max_words=5, seed=5)
_MODEL = dict(feat_dim=16, ivector_dim=0, hidden_dim=32, bottleneck_dim=8,
              time_strides=(1, 2), num_pdfs=16, prefinal_big=32,
              prefinal_small=16, compute_dtype="float32")


@pytest.fixture(scope="module")
def world():
    """Both packages' bundles and 3-gram HCLGs on one word corpus, and a
    state the port trained 60 steps on the CPU, handed to both."""
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**_CORPUS))
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**_CORPUS))
    p = _CORPUS["num_phones"]
    jb = jrec.prepare_data(j[0], j[3], j[4], j[5], p, dev_fraction=0.2)
    tb = trec.prepare_data(t[0], t[3], t[4], t[5], p, dev_fraction=0.2)
    tcfg = tmodel.TdnnfModelConfig(**_MODEL)
    tc = TrainerConfig(optimizer=OptimizerConfig(
        kind="adam", lr_initial=3e-3, lr_final=1e-3, num_steps=60))
    state, _ = trec.train_model(tb, tcfg, tc, 60, batch_size=8,
                                chunk_width=14, seed=0, prefetch=0,
                                device="cpu")
    params = convert.tree_to_numpy(state.params)
    bn = convert.tree_to_numpy(state.bn_state)
    sym = [f"w{w}" for w in range(_CORPUS["vocab_size"])]
    sents = [[sym[w] for w in ws] for ws in t[2]]
    jg = jgs.build_hclg_sparse(jwfst.Lexicon(j[1]),
                               jng.estimate_ngram_lm(sents, order=3), sym,
                               j[5], j[4])
    tg = tgs.build_hclg_sparse(twfst.Lexicon(t[1]),
                               tng.estimate_ngram_lm(sents, order=3), sym,
                               t[5], t[4])
    return dict(jb=jb, tb=tb, jg=jg, tg=tg, tstate=state,
                jstate=_state(params, bn, True),
                jcfg=jmodel.TdnnfModelConfig(**_MODEL), tcfg=tcfg)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_decode_corpus_words_matches_jax(world, num_workers):
    """The same hyps, WER counts and lattice best paths; the trained
    model's WER is clearly below 100%."""
    kw = dict(beam=14.0, max_active=2000, lattice=True, lattice_beam=6.0,
              bucket=16, batch_size=4)
    jr = jrec.decode_corpus_words(None, world["jcfg"], world["jstate"],
                                  world["jg"], world["jb"].dev_utts, **kw)
    tr = trec.decode_corpus_words(None, world["tcfg"], world["tstate"],
                                  world["tg"], world["tb"].dev_utts,
                                  num_workers=num_workers, device="cpu", **kw)
    assert tr["hyps"] == jr["hyps"]
    for k in ("wer", "sub", "ins", "del", "ref_len"):
        assert tr[k] == jr[k], k
    assert tr["wer"] < 25.0, tr["wer"]
    assert len(tr["lattices"]) == len(tr["hyps"])
    for lat, hyp in zip(tr["lattices"], tr["hyps"]):
        assert tlat.lattice_best_path(lat)[0] == hyp


def test_decode_corpus_matches_jax(world):
    """Viterbi phone decode against the dense den: the same PER counts."""
    jr = jrec.decode_corpus(world["jb"], world["jcfg"], world["jstate"],
                            world["jb"].dev_utts[:5])
    tr = trec.decode_corpus(world["tb"], world["tcfg"], world["tstate"],
                            world["tb"].dev_utts[:5], device="cpu")
    assert tr == jr
    assert tr["ref_len"] == sum(len(u.phones)
                                for u in world["tb"].dev_utts[:5])


def test_align_corpus_matches_jax(world):
    """Forced alignment: the same begins and ends; the Viterbi scores of
    align_utterance within 1e-6 relative on the same outputs."""
    utts_j, utts_t = world["jb"].dev_utts[:3], world["tb"].dev_utts[:3]
    ja = jalign.align_corpus(world["jb"], world["jcfg"], world["jstate"],
                             utts_j)
    ta = talign.align_corpus(world["tb"], world["tcfg"], world["tstate"],
                             utts_t, device="cpu")
    for a, b, u in zip(ta, ja, utts_t):
        assert (a.begins, a.ends) == (b.begins, b.ends)
        assert len(a.begins) == len(u.phones) and a.ends[-1] == len(
            u.pdf_align) - 1
    outs = trec.forward_corpus(None, world["tcfg"], world["tstate"], utts_t,
                               device="cpu")
    for obs, u in zip(outs, utts_t):
        tb_, te, ts = talign.align_utterance(obs, u.phones, world["tb"].lm,
                                             world["tb"].topo,
                                             world["tb"].tree, device="cpu")
        jb_, je, js = jalign.align_utterance(obs, u.phones, world["jb"].lm,
                                             world["jb"].topo,
                                             world["jb"].tree)
        assert (tb_, te) == (jb_, je)
        assert ts == pytest.approx(js, rel=1e-6)
