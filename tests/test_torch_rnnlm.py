"""The port's RNNLM against the JAX package's (CPU, float32): logits of the
plain, LSTMP, spliced and tied variants, training steps with JAX's
dropout masks injected, a dropout-free ``train_rnnlm`` trajectory with
held-out early stopping, and the scorer's sentence, token, incremental
and frontier-batched scores.  Weights cross through
``convert.rnnlm_params_from_numpy``."""

import math

import jax
import numpy as np
import pytest
import torch

from tdnnf_nas_tpu.lm import rnnlm as jrnn
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.lm import rnnlm as trnn

torch.set_num_threads(1)

_VARIANTS = {
    "plain": dict(),
    "lstmp": dict(proj_dim=6),
    "splice": dict(tdnn_splice=True),
    "tied": dict(proj_dim=8, tie_embeddings=True),  # rec_dim = embed_dim
    "lstmp_splice": dict(proj_dim=6, tdnn_splice=True),
}


def _cfgs(**kw):
    base = dict(vocab_size=9, embed_dim=8, hidden_dim=12, dropout=0.0)
    base.update(kw)
    return jrnn.RnnLMConfig(**base), trnn.RnnLMConfig(**base)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jrnn.init_rnnlm(cfg, jax.random.PRNGKey(
        seed)))


def _sents(n=60, seed=0, vocab=9):
    rng = np.random.RandomState(seed)
    return [[(s + i) % vocab for i in range(rng.randint(2, 7))]
            for s in rng.randint(0, vocab, n)]


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_logits_match_jax(variant):
    """Inference logits within 1e-5 on a padded batch."""
    jcfg, tcfg = _cfgs(**_VARIANTS[variant])
    p = _jax_params(jcfg)
    inp, _ = trnn._pad_batch(_sents(5, 1), tcfg)
    jl = np.asarray(jrnn.rnnlm_logits(jcfg, p, inp.astype(np.int32)))
    tl = trnn.rnnlm_logits(tcfg, convert.rnnlm_params_from_numpy(p, "cpu"),
                           torch.as_tensor(inp))
    assert tl.shape == jl.shape == (5, inp.shape[1], jcfg.full_vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)


def test_init_shapes_and_converter_round_trip():
    """init_rnnlm draws the reference's leaves and shapes; the converter
    carries every leaf, the optional wp and tdnn ones too, both ways."""
    jcfg, tcfg = _cfgs(proj_dim=6, tdnn_splice=True)
    jp = _jax_params(jcfg)
    tp = trnn.init_rnnlm(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat = lambda t: {k: v.shape for k, v in trnn._leaves(t)}
    assert flat(tp) == {k: tuple(v.shape) for k, v in trnn._leaves(jp)}
    back = convert.rnnlm_params_to_numpy(
        convert.rnnlm_params_from_numpy(jp, "cpu"))
    for (k, a), (k2, b) in zip(trnn._leaves(back), trnn._leaves(jp)):
        assert k == k2 and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _jax_masks(cfg, seed, n_steps, shape):
    """The dropout keep-masks jax's train_rnnlm draws at each step."""
    key = jax.random.PRNGKey(seed + 1)
    masks = []
    for _ in range(n_steps):
        key, dk = jax.random.split(key)
        masks.append(np.asarray(jax.random.bernoulli(dk, 1.0 - cfg.dropout,
                                                     shape)))
    return masks


def test_training_steps_with_jax_dropout_masks():
    """Three Adam steps with dropout 0.3: JAX's masks injected, the same
    numpy batches; parameters within 1e-5 of JAX's."""
    jcfg, tcfg = _cfgs(proj_dim=6, tdnn_splice=True, dropout=0.3)
    sents = _sents(40, 2)
    steps, bs = 3, 8
    max_len = max(len(s) for s in sents)
    masks = _jax_masks(jcfg, 0, steps, (bs, max_len + 1, jcfg.embed_dim))
    jp, _ = jrnn.train_rnnlm(sents, jcfg, num_steps=steps, batch_size=bs,
                             lr=1e-2, seed=0)
    tp, _ = trnn.train_rnnlm(
        sents, tcfg, num_steps=steps, batch_size=bs, lr=1e-2, seed=0,
        params=convert.rnnlm_params_from_numpy(_jax_params(jcfg), "cpu"),
        dropout_masks=lambda i, shape: torch.tensor(masks[i]),
        device="cpu")
    for (k, a), (_, b) in zip(trnn._leaves(tp), trnn._leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))


def test_train_trajectory_and_early_stopping_match_jax():
    """40 dropout-free steps with a decaying rate and held-out checks every
    10: the same best perplexity (rtol 1e-4) and parameters (1e-4)."""
    jcfg, tcfg = _cfgs(proj_dim=6)
    sents, held = _sents(80, 3), _sents(24, 4)
    kw = dict(num_steps=40, batch_size=8, lr=2e-2, lr_final=2e-3, seed=5,
              heldout=held, eval_every=10)
    jp, jppl = jrnn.train_rnnlm(sents, jcfg, **kw)
    tp, tppl = trnn.train_rnnlm(
        sents, tcfg,
        params=convert.rnnlm_params_from_numpy(_jax_params(jcfg, 5), "cpu"),
        device="cpu", **kw)
    assert math.isfinite(tppl)
    np.testing.assert_allclose(tppl, jppl, rtol=1e-4)
    for (k, a), (_, b) in zip(trnn._leaves(tp), trnn._leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=str(k))


def test_early_stopping_keeps_the_best():
    """An lr that diverges after a while: the returned parameters are the
    copy at the best held-out check, not the last, and score that
    perplexity."""
    _, tcfg = _cfgs()
    sents = _sents(80, 6)
    tp, ppl = trnn.train_rnnlm(sents, tcfg, num_steps=30, batch_size=8,
                               lr=0.5, seed=0, heldout=sents[:16],
                               eval_every=5, device="cpu")
    last, _ = trnn.train_rnnlm(sents, tcfg, num_steps=30, batch_size=8,
                               lr=0.5, seed=0, device="cpu")
    held = [s for s in sents[:16]]
    sc = trnn.RnnLMScorer(tcfg, tp)
    nll = -sum(sc.score(s) / trnn._LOG10E for s in held)
    n_tok = sum(len(s) + 1 for s in held)
    np.testing.assert_allclose(math.exp(nll / n_tok), ppl, rtol=1e-4)
    assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(
        trnn._leaves(tp), trnn._leaves(last)))


@pytest.fixture(scope="module")
def scorers():
    jcfg, tcfg = _cfgs(proj_dim=6, tdnn_splice=True)
    p = _jax_params(jcfg, 7)
    return (jrnn.RnnLMScorer(jcfg, p),
            trnn.RnnLMScorer(tcfg, convert.rnnlm_params_from_numpy(p, "cpu")))


def test_sentence_and_token_scores_match_jax(scorers):
    js, ts = scorers
    for words in ([], [3], [2, 0, 8, 1], [5, 5, 5, 5, 5, 5]):
        np.testing.assert_allclose(ts.score(words), js.score(words),
                                   rtol=1e-5, atol=1e-5)
    inp, tgt = trnn._pad_batch(_sents(6, 8), ts.cfg)
    jl = np.asarray(js.token_logprobs(inp.astype(np.int32),
                                      tgt.astype(np.int32)))
    tl = ts.token_logprobs(inp, tgt)
    assert tl.device.type == "cpu"
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)
    assert (tl.numpy()[tgt < 0] == 0).all()


def test_incremental_scores_match_jax_and_the_sentence_score(scorers):
    js, ts = scorers
    words = [2, 0, 7, 1, 4]
    jst, tst = js.initial_state(), ts.initial_state()
    total = 0.0
    for w in words:
        jlp, jst = js.advance(jst, w)
        tlp, tst = ts.advance(tst, w)
        np.testing.assert_allclose(tlp, jlp, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tst[-1], jst[-1], rtol=1e-5, atol=1e-5)
        total += tlp
    np.testing.assert_allclose(ts.final_logprob(tst), js.final_logprob(jst),
                               rtol=1e-5, atol=1e-5)
    total += ts.final_logprob(tst)
    np.testing.assert_allclose(total, ts.score(words) / trnn._LOG10E,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 3, 8, 11])
def test_advance_batch_matches_jax_with_and_without_row_padding(scorers, n):
    """n frontier rows (a final arc's -1 among them): the port advances
    them unpadded; JAX pads to a power of two (>= 8).  The port's rows
    also equal those of its own call on the rows padded the same way."""
    js, ts = scorers
    rng = np.random.RandomState(n)
    h0, c0, px0 = ts.initial_state_batch()
    jh, jc, jpx = js.initial_state_batch()
    # a frontier of distinct states: advance <s> by n words first
    first = rng.randint(0, 9, n)
    idx = np.zeros(n, np.int64)
    th, tc, tpx, _, _ = ts.advance_batch(h0[idx], c0[idx], px0[idx], first)
    jh2, jc2, jpx2 = (a[:n] for a in js.advance_batch(
        jh[idx], jc[idx], jpx[idx], first)[:3])
    words = rng.randint(0, 9, n)
    words[0] = -1
    out_t = ts.advance_batch(th, tc, tpx, words)
    out_j = js.advance_batch(jh2, jc2, jpx2, words)
    for a, b in zip(out_t, out_j):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)[: len(a)]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    pad = max(8, 1 << (n - 1).bit_length()) - n
    padrows = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    out_p = ts.advance_batch(padrows(th), padrows(tc), padrows(tpx),
                             np.pad(words, (0, pad)))
    for a, b in zip(out_t, out_p):
        b = b[:n]
        if isinstance(a, torch.Tensor):
            a, b = a.numpy(), b.numpy()
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_bidirectional_scorer_matches_jax():
    jcfg, tcfg = _cfgs()
    pf, pb = _jax_params(jcfg, 1), _jax_params(jcfg, 2)
    jb = jrnn.BidirectionalRnnLMScorer(jrnn.RnnLMScorer(jcfg, pf),
                                       jrnn.RnnLMScorer(jcfg, pb), 0.3)
    tb = trnn.BidirectionalRnnLMScorer(
        trnn.RnnLMScorer(tcfg, convert.rnnlm_params_from_numpy(pf, "cpu")),
        trnn.RnnLMScorer(tcfg, convert.rnnlm_params_from_numpy(pb, "cpu")),
        0.3)
    for words in ([1, 2, 3], [8, 0], []):
        np.testing.assert_allclose(tb.score(words), jb.score(words),
                                   rtol=1e-5, atol=1e-5)
    sents = [[1, 2, 3], [4]]
    assert trnn.reverse_sentences(sents) == jrnn.reverse_sentences(sents)
    with pytest.raises(ValueError):
        trnn.BidirectionalRnnLMScorer(tb.forward, tb.backward, 1.5)
