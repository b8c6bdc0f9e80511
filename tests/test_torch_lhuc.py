"""LHUC on the port against the JAX package (CPU): identity at init,
``post_bn_scales`` in float32 and bf16 (the bf16 x float32 promotion),
``adapt_lhuc`` through the blocked den's plain scan, the
pad-by-repetition batches of ``lhuc_adapt_and_decode``, and the stage as
a whole (enrollment, adapted decode, WER) on a small word corpus."""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnnf_nas_tpu.models import lhuc as jlhuc
from tdnnf_nas_tpu.models import tdnnf as jmodel
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.models import lhuc as tlhuc
from tdnnf_nas_torch.models import tdnnf as tmodel
from tdnnf_nas_torch.tools import e2e_flagship as te2e

torch.set_num_threads(1)

_SMALL = dict(feat_dim=8, ivector_dim=4, hidden_dim=16, bottleneck_dim=4,
              time_strides=(1, 2, 0, 3), num_pdfs=6, prefinal_big=16,
              prefinal_small=8, compute_dtype="float32")


def _jax_model(cfg, seed=0):
    """JAX-initialised params (output layers randomised, so that the
    scales reach the logits) and bn_state with non-trivial stats."""
    params, bn = jmodel.init_model(cfg, jax.random.PRNGKey(seed))
    params, bn = (jax.tree.map(np.asarray, t) for t in (params, bn))
    rng = np.random.RandomState(seed + 9)
    for head in ("chain", "xent"):
        w = params[f"output_{head}"]["w"]
        params[f"output_{head}"]["w"] = (rng.randn(*w.shape) * 0.3).astype(
            np.float32)
    for st in bn.values():
        st["mean"] = (rng.randn(*st["mean"].shape) * 0.1).astype(np.float32)
        st["var"] = (1.0 + rng.rand(*st["var"].shape)).astype(np.float32)
    return params, bn


def _inputs(cfg, b=2, t_out=3, seed=0):
    rng = np.random.RandomState(seed)
    t_in = jmodel.chunk_input_frames(cfg, t_out)
    return (rng.randn(b, t_in, cfg.feat_dim).astype(np.float32),
            rng.randn(b, cfg.ivector_dim).astype(np.float32))


def _port(params, bn):
    return (convert.tree_to_torch(params, device="cpu"),
            convert.tree_to_torch(bn, device="cpu"))


def test_identity_at_init_and_scaled_logits_match_jax():
    jcfg, tcfg = (jmodel.TdnnfModelConfig(**_SMALL),
                  tmodel.TdnnfModelConfig(**_SMALL))
    params, bn = _jax_model(jcfg)
    tp, tbn = _port(params, bn)
    feats, iv = _inputs(jcfg)
    lhuc = tlhuc.init_lhuc(tcfg, device="cpu")
    assert sorted(lhuc) == sorted(jlhuc.init_lhuc(jcfg))
    assert all(v.dtype == torch.float32 and v.shape == (16,)
               for v in lhuc.values())
    c0, _, _ = tmodel.apply_model(tcfg, tp, tbn, torch.tensor(feats),
                                  torch.tensor(iv))
    c1, _, _ = tlhuc.apply_model_lhuc(tcfg, tp, tbn, lhuc,
                                      torch.tensor(feats), torch.tensor(iv))
    np.testing.assert_array_equal(c0.numpy(), c1.numpy())
    # per-unit logits: JAX's output within 1e-5, and the scales act
    rng = np.random.RandomState(3)
    logits = {k: rng.randn(16).astype(np.float32) for k in lhuc}
    jc, jx, _ = jlhuc.apply_model_lhuc(jcfg, params, bn, logits,
                                       jnp.asarray(feats), jnp.asarray(iv))
    tc, tx, _ = tlhuc.apply_model_lhuc(
        tcfg, tp, tbn, convert.lhuc_from_numpy(logits, "cpu"),
        torch.tensor(feats), torch.tensor(iv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(tc.numpy(), c0.numpy())
    back = convert.lhuc_to_numpy(convert.lhuc_from_numpy(logits, "cpu"))
    assert all(np.array_equal(back[k], logits[k]) for k in logits)


def _bf16_pair(seed, shape=(2, 5, 16)):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


def test_post_bn_scale_promotes_bf16_like_jax():
    """A bf16 activation times a float32 scale is float32 in both, bit
    for bit; the bypass then mixes dtypes: float32 cur with bf16 prev,
    and bf16 cur with float32 prev, each equal to jnp bit for bit."""
    jx, tx = _bf16_pair(0)
    s = (2.0 / (1.0 + np.exp(-np.random.RandomState(1).randn(16)))).astype(
        np.float32)
    ref = jx * jnp.asarray(s)
    out = tmodel._scale(tx, {"l": torch.tensor(s)}, "l")
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert tmodel._scale(tx, {"l": torch.tensor(s)}, "other") is tx
    jp, tp = _bf16_pair(2)
    for jcur, tcur, jprev, tprev in ((ref, out, jp, tp), (jp, tp, ref, out)):
        r = jcur + jnp.asarray(0.66, jcur.dtype) * jprev
        o = tmodel._bypass(tcur, tprev, 0.66)
        assert o.dtype == torch.float32 and r.dtype == jnp.float32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_post_bn_scales_bf16_forward_matches_jax():
    """The bf16 model with scales on every layer: after tdnn1 the stack
    runs in float32 activations in both packages (the bf16 products
    round differently, so the bar is bf16's: 2e-2 of the largest
    logit)."""
    cfg = dict(_SMALL, compute_dtype="bfloat16")
    jcfg, tcfg = jmodel.TdnnfModelConfig(**cfg), tmodel.TdnnfModelConfig(**cfg)
    params, bn = _jax_model(jcfg, 1)
    tp, tbn = _port(params, bn)
    feats, iv = _inputs(jcfg, seed=4)
    rng = np.random.RandomState(5)
    logits = {k: rng.randn(16).astype(np.float32)
              for k in jlhuc.init_lhuc(jcfg)}
    jc, _, _ = jlhuc.apply_model_lhuc(jcfg, params, bn, logits,
                                      jnp.asarray(feats), jnp.asarray(iv))
    tc, _, _ = tlhuc.apply_model_lhuc(
        tcfg, tp, tbn, convert.lhuc_from_numpy(logits, "cpu"),
        torch.tensor(feats), torch.tensor(iv))
    jc = np.asarray(jc)
    assert tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0,
                               atol=2e-2 * np.abs(jc).max())


# ------------------------------------------------- adaptation, blocked den

def _setup(pkg):
    """A word corpus with 3 speakers and i-vectors, its 4-gram composed
    den (blocked export) and chunks, through one package's modules."""
    if pkg == "jax":
        from tdnnf_nas_tpu.data import synthetic as syn
        from tdnnf_nas_tpu.recipes import chain_recipes as rec
    else:
        from tdnnf_nas_torch.data import synthetic as syn
        from tdnnf_nas_torch.recipes import chain_recipes as rec
    c = syn.make_word_corpus(syn.WordCorpusConfig(
        vocab_size=14, num_phones=6, feat_dim=8, num_utts=40, min_words=8,
        max_words=12, num_speakers=3, speaker_shift=1.0, seed=5))
    utts = c[0]
    iv = np.random.RandomState(7).randn(len(utts), 4).astype(np.float32)
    test, train = utts[:4], utts[4:]
    bundle = rec.prepare_data(train, [u.phones for u in train], c[4], c[5],
                              6, dev_fraction=0.1, phone_lm_order=4,
                              num_extra_lm_states=20, ivectors=list(iv[4:]))
    return dict(corpus=c, test=test, iv_test=list(iv[:4]), bundle=bundle)


_MODEL = dict(feat_dim=8, ivector_dim=4, hidden_dim=16, bottleneck_dim=4,
              time_strides=(1, 1), prefinal_big=16, prefinal_small=8,
              compute_dtype="float32")


@pytest.fixture(scope="module")
def world():
    from tdnnf_nas_torch.recipes import chain_recipes as trec
    from tdnnf_nas_torch.train import OptimizerConfig, TrainerConfig

    j, t = _setup("jax"), _setup("torch")
    assert type(t["bundle"].den_arrays).__name__ == "BlockedDenGraph"
    num_pdfs = t["corpus"][4].num_pdfs
    tcfg = tmodel.TdnnfModelConfig(num_pdfs=num_pdfs, **_MODEL)
    jcfg = jmodel.TdnnfModelConfig(num_pdfs=num_pdfs, **_MODEL)
    tc = TrainerConfig(optimizer=OptimizerConfig(
        kind="adam", lr_initial=3e-3, lr_final=1e-3, num_steps=40))
    state, _ = trec.train_model(t["bundle"], tcfg, tc, 40, batch_size=8,
                                chunk_width=14, seed=0, prefetch=0,
                                max_phones_per_chunk=40, device="cpu")
    return dict(j=j, t=t, jcfg=jcfg, tcfg=tcfg, state=state, tc=tc,
                params=convert.tree_to_numpy(state.params),
                bn=convert.tree_to_numpy(state.bn_state))


def _host_batches(w, pkg, n=2, bs=4):
    if pkg == "jax":
        from tdnnf_nas_tpu.data.egs import batch_iterator
    else:
        from tdnnf_nas_torch.data.egs import batch_iterator
    cfg = w["jcfg"] if pkg == "jax" else w["tcfg"]
    chunks = w["j" if pkg == "jax" else "t"]["bundle"].egs(
        cfg, chunk_width=14, max_phones_per_chunk=40)
    it = batch_iterator(chunks, bs, np.random.RandomState(1))
    return [next(it) for _ in range(n)]


def test_adapt_lhuc_matches_jax_through_the_blocked_den(world):
    """4 SGD steps (lr 0.5, l2 0.1) cycling 2 batches of 4 with
    i-vectors, the model frozen: the logits within 1e-5 of JAX's and the
    last step's objf within 1e-5; the model's tensors untouched."""
    from tdnnf_nas_tpu.train import TrainerConfig as JTrainerConfig
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    jb = [jax.tree.map(jnp.asarray, b) for b in _host_batches(world, "jax")]
    tb = [convert.batch_to_torch(b, "cpu")
          for b in _host_batches(world, "torch")]
    jparams = jax.tree.map(jnp.asarray, world["params"])
    jbn = jax.tree.map(jnp.asarray, world["bn"])
    jl, jm = jlhuc.adapt_lhuc(world["jcfg"], jparams, jbn,
                              world["j"]["bundle"].den_arrays,
                              JTrainerConfig().objective, jb, num_steps=4,
                              lr=0.5, l2=0.1)
    den = BlockedDenGraph.from_host(world["t"]["bundle"].den_arrays, "cpu")
    before = {k: v.clone() for k, v in world["state"].params["tdnn1"].items()}
    seen = []
    tl, tm = tlhuc.adapt_lhuc(world["tcfg"], world["state"].params,
                              world["state"].bn_state, den,
                              world["tc"].objective, tb, num_steps=4, lr=0.5,
                              l2=0.1, on_step=seen.append, device="cpu")
    assert len(seen) == 4 and seen[-1] is tm
    assert all(torch.equal(before[k], world["state"].params["tdnn1"][k])
               for k in before)
    jl = jax.tree.map(np.asarray, jl)
    assert max(float(np.abs(v).max()) for v in jl.values()) > 1e-3
    for k, v in convert.lhuc_to_numpy(tl).items():
        np.testing.assert_allclose(v, jl[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tm["objf_mmi"]), float(jm["objf_mmi"]),
                               rtol=1e-5, atol=1e-5)


def test_lhuc_batches_pad_by_repeating_the_first_chunk(world):
    """Batches of 16 from 21 chunks: the short last batch is padded with
    copies of its first chunk, leaf for leaf as the reference's
    ``jax.tree.map`` pads JAX's batches."""
    from tdnnf_nas_tpu.data.egs import batch_iterator as jbatches

    j, t = world["j"]["bundle"], world["t"]["bundle"]
    jchunks = j.egs(world["jcfg"], chunk_width=14,
                    max_phones_per_chunk=40)[:21]
    tchunks = t.egs(world["tcfg"], chunk_width=14,
                    max_phones_per_chunk=40)[:21]
    sizes = []
    ref = []
    for b in jbatches(jchunks, 16, np.random.RandomState(0),
                      drop_last=False):
        n_b = b["feats"].shape[0]
        sizes.append(n_b)
        if n_b < 16:  # scripts/e2e_flagship.py:519-525
            b = jax.tree.map(
                lambda a: (np.concatenate([a, np.repeat(a[:1], 16 - n_b, 0)])
                           if isinstance(a, np.ndarray) and a.ndim
                           and a.shape[0] == n_b else a), b)
        ref.append(b)
        if len(ref) >= 8:
            break
    got = te2e.lhuc_batches(tchunks)
    assert any(s < 16 for s in sizes) and len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["feats"].shape[0] == 16
        np.testing.assert_array_equal(g["feats"], r["feats"])
        np.testing.assert_array_equal(g["ivectors"], r["ivectors"])
        for f in ("trans", "state_pdf", "init", "final", "mask", "next_w"):
            np.testing.assert_array_equal(getattr(g["sup"], f),
                                          getattr(r["sup"], f))


def _reference_stage():
    """``scripts/e2e_flagship.py`` as a module (its imports are lazy)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "e2e_flagship.py")
    spec = importlib.util.spec_from_file_location("_e2e_flagship_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lhuc_adapt_and_decode_matches_jax(world):
    """The stage on both packages from one state: 3 speakers' enrollment
    (3 steps) and the adapted decode of the 4 test utterances give the
    same WER before and after."""
    from tdnnf_nas_tpu.decode import graph_sparse as jgs
    from tdnnf_nas_tpu.decode import wfst as jwfst
    from tdnnf_nas_tpu.lm import ngram as jng
    from tdnnf_nas_tpu.train import TrainerConfig as JTrainerConfig
    from tdnnf_nas_torch.decode import graph_sparse as tgs
    from tdnnf_nas_torch.decode import wfst as twfst
    from tdnnf_nas_torch.lm import ngram as tng

    sym = [f"w{w}" for w in range(14)]
    out = {}
    for pkg, gs, wf, ng in (("j", jgs, jwfst, jng), ("t", tgs, twfst, tng)):
        c, test = world[pkg]["corpus"], world[pkg]["test"]
        lm = ng.estimate_ngram_lm([[sym[w] for w in ws] for ws in c[2]], 3)
        g = gs.build_hclg_sparse(wf.Lexicon(c[1]), lm, sym, c[5], c[4])
        refs = [list(u.words) for u in test]
        base = [r[:-1] for r in refs]
        args = (world[pkg]["bundle"], c[5], c[4], g, test, refs,
                world[pkg]["iv_test"])
        if pkg == "j":
            state = types.SimpleNamespace(
                params=jax.tree.map(jnp.asarray, world["params"]),
                bn_state=jax.tree.map(jnp.asarray, world["bn"]))
            out[pkg] = _reference_stage().lhuc_adapt_and_decode(
                *args, JTrainerConfig().objective, world["jcfg"], state,
                True, base, num_steps=3)
        else:
            out[pkg] = te2e.lhuc_adapt_and_decode(
                *args, world["tc"].objective, world["tcfg"], world["state"],
                True, base, num_steps=3, device="cpu")
    assert out["t"]["speakers"] == out["j"]["speakers"] == 3
    assert out["t"]["utts"] == out["j"]["utts"] == 4
    assert out["t"]["wer_before"] == pytest.approx(out["j"]["wer_before"],
                                                   abs=0.01)
    assert out["t"]["wer_after"] == pytest.approx(out["j"]["wer_after"],
                                                  abs=0.01)
    assert len(out["t"]["max_abs_logit"]) == 3
    assert min(out["t"]["max_abs_logit"]) > 0.0
