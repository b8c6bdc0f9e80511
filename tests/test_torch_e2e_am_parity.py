"""The flagship acoustic model's whole run, not one step, held against the
reference on the CPU: both packages train the same narrowed TDNN-F from
the same initial state (JAX's ``PRNGKey(0)`` draw, carried across) with
the same dropout masks (the reference's key schedule, passed into the
port), on the same corpus, bootstrap, i-vectors and den, for 60 steps
under ``DROPOUT_SCHEDULE`` in float32 at B = 64, W = 50, through each
package's ``train_model`` as ``scripts/e2e_flagship.py:292`` calls it.
Then each decodes the test utterances with its own trained parameters,
and the port decodes once more with the reference's.

The run is cut so that its model decodes within a CPU test's time: the
decode checks mean little on a model that has not learned (the
flagship's corpus and 7q at this budget decode at ~97% WER, almost all
deletions).  The corpus is the reference's word corpus with 20 phones in
place of 46 (a den of S = 840, not 4,324), emission noise 2.0 in place
of 4.5 and no lookahead term; the GMM ladder and the tree run at about
the small preset of ``tests/test_torch_e2e_driver.py`` (which holds them
equal to the reference's) on 80 utterances and a 100-word vocabulary;
the model is tdnn1 and 6 TDNN-F layers (the 7q has 14) of 128 with a
32-dim bottleneck, and Adam starts at 5e-3 (the reference's 1e-3
schedule learns too slowly here).  Each package's WER must stay under
``WER_CEILING``.  The file runs ~95 s on one worker, about 40 s of it
the reference's steps and 30 s the port's."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.models import tdnnf as ttdnnf
from tdnnf_nas_torch.recipes.chain_recipes import train_model
from tdnnf_nas_torch.tools import e2e_flagship as te2e

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 60
LR0 = 5e-3
# a model that decodes: both packages come to 11.8% WER here
WER_CEILING = 40.0
# the repo's multi-step objf bar (__graft_entry__.py:119), over every step
OBJF_BAR = 5e-4

PARITY = dataclasses.replace(
    te2e.E2eSizes.smoke(), n_test=10, vocab_size=100, num_utts=80,
    num_text_sents=200, tri_leaves=30, train_subset=30, tree_leaves=20,
    ubm_utts=20, ubm_gauss=4, tmat_utts=30, extra_lm_states=0,
    train_steps=STEPS,
    model_overrides=(("hidden_dim", 128), ("bottleneck_dim", 32),
                     ("prefinal_big", 128), ("prefinal_small", 64),
                     ("time_strides", (1, 1, 0, 3, 3, 3))))
CORPUS = dict(num_phones=20, emission_noise=2.0, lookahead_scale=0.0)
_FLAGSHIP_CORPUS = te2e.word_corpus_config


def _corpus_config(sizes):
    """The flagship's word corpus with ``CORPUS`` on top."""
    return dataclasses.replace(_FLAGSHIP_CORPUS(sizes), **CORPUS)


def _reference():
    path = os.path.join(REPO, "scripts", "e2e_flagship.py")
    spec = importlib.util.spec_from_file_location("_e2e_flagship_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_side(port, ref):
    """The reference's corpus with the port's bootstrap alignments, its
    own TriphoneTree on the port's table, and its ``prepare_data`` on the
    port's i-vectors (``tests/test_torch_e2e_driver.py`` holds each of
    these equal to the reference's own chain)."""
    import tdnnf_nas_tpu.data.synthetic as jsyn
    import tdnnf_nas_tpu.graphs.topology as jtopo
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    cfg = te2e.word_corpus_config(PARITY)
    utts, prons, word_seqs, _, _, topo, text = jsyn.make_word_corpus(
        jsyn.WordCorpusConfig(**dataclasses.asdict(cfg)))
    test, train = utts[:PARITY.n_test], utts[PARITY.n_test:]
    for u, p in zip(train, port.train):
        u.begins, u.ends = list(p.begins), list(p.ends)
    tree = jtopo.TriphoneTree(cfg.num_phones, port.tree._fwd_table,
                              port.tree._n_fwd)
    bundle = jrec.prepare_data(
        train, [u.phones for u in train], tree, topo, cfg.num_phones,
        dev_fraction=0.05, phone_lm_order=4,
        num_extra_lm_states=PARITY.extra_lm_states,
        ivectors=list(port.iv_train))
    ref.N_TEST = PARITY.n_test
    word_sym, lm3, _ = ref.build_graph(cfg, prons, word_seqs, text)
    return dict(test=test, tree=tree, topo=topo, prons=prons, bundle=bundle,
                word_sym=word_sym, lm3=lm3)


def _reference_masks(jtc, batch: int, hidden: int, sites: int):
    """The dropout masks the reference's ``train_model(seed=0)`` draws, in
    the order it draws them, from its own key schedule: step ``i``'s key
    ``fold_in(PRNGKey(1), i)`` split into (model, dropout) keys
    (``tdnnf_nas_tpu/train/trainer.py:196-199``), the dropout key split
    into 32, one per site in layer order (``models/tdnnf.py:290``), each
    mask ``bernoulli(key, 1 - p, [B, 1, hidden])`` at the step's
    scheduled ``p`` (``:255-256``, ``trainer.py:118-125``).  Drawn on the
    host, so the reference's jitted step runs as it is."""
    import jax.numpy as jnp
    from tdnnf_nas_tpu.train.trainer import _dropout_at

    key, masks = jax.random.PRNGKey(1), []
    for i in range(STEPS):
        p = _dropout_at(jnp.asarray(i, jnp.int32), jtc, STEPS)
        keep = 1.0 - jnp.asarray(p, jnp.float32)
        _, k_drop = jax.random.split(jax.random.fold_in(key, i))
        for k in jax.random.split(k_drop, 32)[:sites]:
            masks.append(np.array(jax.random.bernoulli(
                k, keep, (batch, 1, hidden))))
    return masks


def _replaying_dropout(masks):
    """The port's ``_dropout`` with the reference's masks, in the order
    the reference drew them (at p = 0 its mask is all ones)."""

    def dropout(x, p, generator, train, mesh=None):
        if not train or generator is None:
            return x
        mask = masks.pop(0)
        assert mask.shape == (x.shape[0], 1, x.shape[-1])
        return ttdnnf._apply_dropout(x, torch.from_numpy(mask), p)

    return dropout


def _to_port(jstate):
    return convert.train_state_from_numpy(
        *jax.tree.map(np.asarray, (jstate.params, jstate.bn_state,
                                   jstate.opt_state)),
        int(jstate.step), device="cpu")


@pytest.fixture(scope="module")
def runs():
    import tdnnf_nas_tpu.decode.graph_sparse as jgs
    import tdnnf_nas_tpu.decode.wfst as jwfst
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec
    import tdnnf_nas_tpu.train as jtrain

    ref = _reference()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(te2e, "word_corpus_config", _corpus_config)
        port = te2e.build_setup(PARITY, device="cpu")
        jside = _reference_side(port, ref)
    mc = te2e.model_config(port.tree, port.cfg, "float32",
                           PARITY.model_overrides)
    jmc = jmodels.TdnnfModelConfig.from_json(mc.to_json())
    jtc = ref.trainer_config(STEPS, lr0=LR0)
    jinit = jtrain.init_train_state(jmc, jtc, jax.random.PRNGKey(0))
    jstate, jmetrics = jrec.train_model(jside["bundle"], jmc, jtc, STEPS,
                                        batch_size=64, chunk_width=50, seed=0)
    masks = _reference_masks(jtc, 64, mc.hidden_dim, 1 + mc.num_tdnnf)
    drawn, dropped = len(masks), int(sum((m == 0).sum() for m in masks))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttdnnf, "_dropout", _replaying_dropout(masks))
        state, metrics = train_model(
            port.bundle, mc, te2e.trainer_config(STEPS, lr0=LR0), STEPS,
            batch_size=64, chunk_width=50, seed=0,
            init_state=_to_port(jinit), device="cpu")
    word_sym, lm3, _ = te2e.build_graph(port.cfg, port.prons,
                                        port.word_seqs, port.text,
                                        PARITY.n_test)
    g = te2e.build_hclg(port, lm3, word_sym)
    jg = jgs.build_hclg_sparse(jwfst.Lexicon(jside["prons"]), jside["lm3"],
                               jside["word_sym"], jside["topo"],
                               jside["tree"], split_unigram=False)
    # the reference's stage-5 call (scripts/e2e_flagship.py:316-321), its
    # searches in this process (no fork under JAX's threads)
    jrep = jrec.decode_corpus_words(
        jside["bundle"], jmc, jstate, jg, jside["test"], acoustic_scale=1.0,
        beam=16.0, max_active=10000, lattice=False, lattice_beam=8.0,
        num_workers=0, ivectors=list(port.iv_test))
    return dict(
        port_objf=[v for _, v in metrics.series["objf_mmi"]],
        ref_objf=[float(v) for _, v in jmetrics.series["objf_mmi"]],
        drawn=drawn, dropped=dropped, left=len(masks),
        num_tdnnf=mc.num_tdnnf,
        port_rep=te2e.decode(port, mc, state, g, device="cpu"),
        cross_rep=te2e.decode(port, mc, _to_port(jstate), g, device="cpu"),
        ref_rep=jrep)


def test_every_reference_mask_is_replayed(runs):
    """One of the reference's masks per dropout site (tdnn1 and each
    TDNN-F layer) per step, each consumed by the port in turn; the
    schedule drops units."""
    assert runs["drawn"] == STEPS * (1 + runs["num_tdnnf"])
    assert runs["left"] == 0
    assert runs["dropped"] > 0


def test_objf_trajectory_matches_the_reference(runs):
    """60 steps from the same state with the same batches and masks: the
    objf within 5e-4 of the reference's at every step."""
    a, b = np.asarray(runs["port_objf"]), np.asarray(runs["ref_objf"])
    assert a.shape == b.shape == (STEPS,)
    assert np.all(np.isfinite(a))
    d = np.abs(a - b)
    print(f"objf |port - reference| over {STEPS} steps: max {d.max():.2e}")
    assert d.max() <= OBJF_BAR, d
    assert a[-1] > a[0]  # it trains


def test_each_package_decodes_within_one_word(runs):
    """Each package's own decode of its own trained model: word errors
    within one of the other's, each model under the WER ceiling."""
    p, r = runs["port_rep"], runs["ref_rep"]
    assert p["ref_len"] == r["ref_len"] > 0
    errors = [rep["sub"] + rep["ins"] + rep["del"] for rep in (p, r)]
    print(f"word errors of {r['ref_len']}: port {errors[0]}, reference "
          f"{errors[1]} (WER {p['wer']:.1f}, {r['wer']:.1f})")
    assert max(p["wer"], r["wer"]) < WER_CEILING, (p["wer"], r["wer"])
    assert abs(errors[0] - errors[1]) <= 1, errors


def test_port_decode_of_the_reference_model_gives_its_hypotheses(runs):
    """The port's decode path on the reference's trained parameters gives
    the reference's hypotheses word for word, on a model under the WER
    ceiling."""
    assert runs["ref_rep"]["wer"] < WER_CEILING
    assert runs["cross_rep"]["hyps"] == runs["ref_rep"]["hyps"]
    assert runs["cross_rep"]["wer"] == runs["ref_rep"]["wer"]
