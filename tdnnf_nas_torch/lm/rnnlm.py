"""Recurrent (LSTM) language model for n-best and lattice rescoring (port
of ``tdnnf_nas_tpu.lm.rnnlm``).

Equivalent of the reference's kaldi-rnnlm stage
(`local/rnnlm/run_tdnn_lstm_fbk40_mod_hasfisher_large_drop_e40.sh`: a
TDNN-LSTM LM, embed 1024 / cell 2048 / rpd 512, used for lattice and
n-best rescoring): an optional ReLU splice over neighbouring embeddings,
an LSTM with an optional recurrent projection (LSTMP), Adam with an
exponential learning-rate decay and held-out early stopping, and a
scorer whose ``score()`` is log10 like the n-gram LM's.

Parameters are the JAX package's nested dict, keys and layouts one to
one (``convert.rnnlm_params_from_numpy``).  The LSTM is a loop over time
whose input products are one GEMM over all frames; every product is
``torch.matmul``.  The reference pads the rows of a frontier batch to a
power of two for stable jit shapes; the port takes the rows as they
come (the rows are independent, tested).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device

_LOG10E = 1.0 / math.log(10.0)


@dataclasses.dataclass(frozen=True)
class RnnLMConfig(Config):
    vocab_size: int = 100  # real words; BOS/EOS appended internally
    embed_dim: int = 64
    hidden_dim: int = 128
    # LSTMP recurrent projection (Kaldi-RNNLM "rpd"); 0 = plain LSTM
    proj_dim: int = 0
    # ReLU(W [x_{t-1}; x_t] + b) over the embeddings before the LSTM
    tdnn_splice: bool = False
    dropout: float = 0.15
    tie_embeddings: bool = False

    @property
    def rec_dim(self) -> int:
        """Recurrent state width seen by the gates / output layer."""
        return self.proj_dim or self.hidden_dim

    @property
    def bos(self) -> int:
        return self.vocab_size

    @property
    def eos(self) -> int:
        return self.vocab_size + 1

    @property
    def full_vocab(self) -> int:
        return self.vocab_size + 2


def init_rnnlm(cfg: RnnLMConfig, generator: torch.Generator,
               device=DEFAULT_DEVICE):
    """Parameters of the reference's shapes and init scheme (N(0, 0.01)
    embeddings, N(0, 1/fan_in) weights, zero biases), drawn on the host
    from ``generator`` and moved to ``device``; the draws differ from
    jax.random's."""
    device = resolve_device(device)
    v, e, h, r = cfg.full_vocab, cfg.embed_dim, cfg.hidden_dim, cfg.rec_dim

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(device)

    zeros = lambda n: torch.zeros(n, device=device)
    params = {
        "embed": normal((v, e), 0.1),
        "lstm": {"wx": normal((e, 4 * h), 1 / np.sqrt(e)),
                 "wh": normal((r, 4 * h), 1 / np.sqrt(r)),
                 "b": zeros(4 * h)},
        "out": {"w": normal((r, v), 1 / np.sqrt(r)), "b": zeros(v)},
    }
    if cfg.proj_dim:
        params["lstm"]["wp"] = normal((h, r), 1 / np.sqrt(h))
    if cfg.tdnn_splice:
        params["tdnn"] = {"w": normal((2 * e, e), 1 / np.sqrt(2 * e)),
                          "b": zeros(e)}
    return params


def _gates_step(params, gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM(P) step from the input part of the gates ``gx`` (x_t @ wx):
    gate order i, f, g, o, the forget gate biased by +1; with a
    projection ``wp`` the recurrent state is (o * tanh(c)) @ wp.  Returns
    (h, c)."""
    lstm = params["lstm"]
    gates = gx + h @ lstm["wh"] + lstm["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    m = torch.sigmoid(o) * torch.tanh(c)
    wp = lstm.get("wp")
    return (m @ wp if wp is not None else m), c


def _lstm_cell(params, h, c, x_t):
    """One (optionally projected) LSTM step on input x_t: (h_rec, c)."""
    return _gates_step(params, x_t @ params["lstm"]["wx"], h, c)


def _lstm_scan(params, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, E] -> recurrent states [B, T, R] from zero states: the
    input products of all frames in one GEMM, then a loop over T."""
    b, t, _ = x.shape
    h = x.new_zeros((b, params["lstm"]["wh"].shape[0]))
    c = x.new_zeros((b, params["lstm"]["wx"].shape[1] // 4))
    gx = x @ params["lstm"]["wx"]
    hs = []
    for k in range(t):
        h, c = _gates_step(params, gx[:, k], h, c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _splice(cfg: RnnLMConfig, params, prev: torch.Tensor, x: torch.Tensor):
    """The TDNN splice ReLU([x_{t-1}; x_t] @ W + b), or x without it."""
    if not cfg.tdnn_splice:
        return x
    return torch.relu(torch.cat([prev, x], dim=-1) @ params["tdnn"]["w"]
                      + params["tdnn"]["b"])


def _output(cfg: RnnLMConfig, params, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["out"]["w"] + params["out"]["b"]


def rnnlm_logits(cfg: RnnLMConfig, params, tokens: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 train: bool = False,
                 dropout_mask: Optional[torch.Tensor] = None):
    """tokens [B, T] (inputs, BOS-prefixed) -> next-token logits [B, T, V].

    In training, embedding dropout keeps each element with probability
    1 - ``cfg.dropout``: the keep mask is ``dropout_mask`` if given (the
    parity tests pass JAX's), else drawn from ``generator`` (no dropout
    without either).  The splice's t = 0 repeats the first frame."""
    x = params["embed"][tokens]
    if train and cfg.dropout > 0:
        keep = 1.0 - cfg.dropout
        if dropout_mask is None and generator is not None:
            dropout_mask = torch.bernoulli(
                torch.full(x.shape, keep, device=x.device),
                generator=generator)
        if dropout_mask is not None:
            x = x * dropout_mask.to(x.dtype) / keep
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    return _output(cfg, params, _lstm_scan(params, _splice(cfg, params, prev,
                                                           x)))


def _pad_batch(sents: Sequence[Sequence[int]], cfg: RnnLMConfig):
    """(inputs, targets) int64 numpy [B, max_len + 1]: inputs BOS-prefixed
    and EOS-padded, targets EOS-terminated and -1 (ignored) after it."""
    t = max(len(s) for s in sents) + 1
    inp = np.full((len(sents), t), cfg.eos, np.int64)
    tgt = np.full((len(sents), t), -1, np.int64)
    for i, s in enumerate(sents):
        inp[i, 0] = cfg.bos
        inp[i, 1: len(s) + 1] = s
        tgt[i, : len(s)] = s
        tgt[i, len(s)] = cfg.eos
    return inp, tgt


def _token_logprobs(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """ln P of each target under ``logits`` [B, T, V]; 0 where tgt < 0."""
    lp = torch.log_softmax(logits, dim=-1)
    tok = torch.gather(lp, -1, tgt.clamp(min=0)[..., None])[..., 0]
    return torch.where(tgt >= 0, tok, torch.zeros_like(tok))


def _mean_nll(cfg, params, inp, tgt, **kw) -> torch.Tensor:
    """Mean negative log-likelihood over the unmasked targets."""
    tok = _token_logprobs(rnnlm_logits(cfg, params, inp, **kw), tgt)
    return -tok.sum() / torch.clamp((tgt >= 0).sum(), min=1)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _adam_update(params, m, v, grads, t_step: int, lr: float, decay: float):
    """The reference's Adam in place: lr * exp(decay * step), betas 0.9 /
    0.999, bias correction at step t_step + 1, eps 1e-8; scalars in
    float32 as jnp computes them."""
    t = np.float32(t_step + 1.0)
    lr_t = float(np.float32(lr) * np.exp(np.float32(decay)
                                         * np.float32(t_step)))
    bc1 = float(np.float32(1.0) - np.float32(0.9) ** t)
    bc2 = float(np.float32(1.0) - np.float32(0.999) ** t)
    for p, m_, v_, g in zip(params, m, v, grads):
        m_.mul_(0.9).add_(0.1 * g)
        v_.mul_(0.999).add_(0.001 * g * g)
        p.sub_(lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + 1e-8))


def _unflatten(paths, leaves):
    out = {}
    for path, leaf in zip(paths, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def train_rnnlm(
    sentences: Sequence[Sequence[int]],
    cfg: RnnLMConfig,
    num_steps: int = 200,
    batch_size: int = 16,
    lr: float = 2e-3,
    lr_final: float = None,
    seed: int = 0,
    heldout: Sequence[Sequence[int]] = None,
    eval_every: int = 2000,
    params=None,
    dropout_masks=None,
    device=DEFAULT_DEVICE,
):
    """Adam training on ``device``; returns (params, perplexity).

    ``lr_final`` decays the rate exponentially from ``lr`` over
    ``num_steps`` (None: constant).  Batches are drawn as the reference
    draws them (``RandomState(seed).choice``, sentences cut and padded to
    the corpus's longest).  ``heldout`` sentences enable early stopping:
    every ``eval_every`` steps and after the last the held-out perplexity
    is measured (batches of ``batch_size`` from its first 512), and a
    copy of the best parameters is kept and returned with that
    perplexity; without it the last batch's.  ``params`` starts from
    given parameters (default ``init_rnnlm`` from a generator seeded
    ``seed``); dropout masks come from a generator seeded ``seed + 1``
    on ``device``, or ``dropout_masks(step, shape)`` when given (the
    parity tests pass JAX's).
    """
    device = resolve_device(device)
    if params is None:
        params = init_rnnlm(cfg, torch.Generator().manual_seed(seed), device)
    paths, leaves = zip(*_leaves(params))
    leaves = [p.detach().clone().to(device) for p in leaves]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    rng = np.random.RandomState(seed)
    decay = (np.log(lr_final / lr) / max(num_steps - 1, 1)
             if lr_final else 0.0)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    max_len = max(len(s) for s in sentences)

    def batch(sents):
        """Padded to max_len + 1, as the reference buckets its batches."""
        inp, tgt = _pad_batch(sents, cfg)
        pad = max_len + 1 - inp.shape[1]
        inp = np.pad(inp, ((0, 0), (0, pad)), constant_values=cfg.eos)
        tgt = np.pad(tgt, ((0, 0), (0, pad)), constant_values=-1)
        return (torch.as_tensor(inp, device=device),
                torch.as_tensor(tgt, device=device))

    held = []
    if heldout:
        hs = [list(s)[:max_len] for s in heldout]
        held = [batch(hs[j: j + batch_size])
                for j in range(0, min(len(hs), 512), batch_size)
                if len(hs[j: j + batch_size]) == batch_size]

    def held_ppl(p):
        tot, n = 0.0, 0.0
        with torch.no_grad():
            for inp, tgt in held:
                tok = _token_logprobs(rnnlm_logits(cfg, p, inp), tgt)
                tot += float(-tok.sum())
                n += float((tgt >= 0).sum())
        return float(np.exp(tot / max(n, 1.0)))

    best, loss = None, None
    for i in range(num_steps):
        idx = rng.choice(len(sentences), batch_size)
        inp, tgt = batch([list(sentences[j])[:max_len] for j in idx])
        mask = (dropout_masks(i, (batch_size, max_len + 1, cfg.embed_dim))
                if dropout_masks is not None else None)
        for p in leaves:
            p.requires_grad_(True)
        tree = _unflatten(paths, leaves)
        loss = _mean_nll(cfg, tree, inp, tgt, generator=gen, train=True,
                         dropout_mask=mask)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p in leaves:
                p.requires_grad_(False)
            _adam_update(leaves, m, v, grads, i, lr, decay)
        if held and ((i + 1) % eval_every == 0 or i == num_steps - 1):
            ppl = held_ppl(_unflatten(paths, leaves))
            if best is None or ppl < best[0]:
                best = (ppl, [p.clone() for p in leaves])
    if best is not None:
        return _unflatten(paths, best[1]), best[0]
    ppl = float(torch.exp(loss.detach())) if loss is not None else float("inf")
    return _unflatten(paths, leaves), ppl


class RnnLMScorer:
    """Sentence, token, incremental and frontier-batched scores of a
    trained RNNLM, on the device its parameters live on."""

    def __init__(self, cfg: RnnLMConfig, params):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    @torch.no_grad()
    def token_logprobs(self, inp, tgt) -> torch.Tensor:
        """Per-token ln P [B, T] on the device (0 where tgt < 0): the
        batched n-best rescorer's call
        (``decode/rescore.rescore_nbest_rnnlm_batched``)."""
        inp, tgt = self._tensor(inp), self._tensor(tgt)
        return _token_logprobs(rnnlm_logits(self.cfg, self.params, inp), tgt)

    def score(self, words: Sequence[int]) -> float:
        """log10 P(words </s> | <s>)."""
        inp, tgt = _pad_batch([[int(w) for w in words]], self.cfg)
        return float(self.token_logprobs(inp, tgt).sum()) * _LOG10E

    # -- incremental API (decode/lattice.rescore_lattice_rnnlm) ----------
    # A state is (h [R], c [H], prev_x [E], logp [V] on the host) after
    # consuming a prefix; natural-log scores.

    @torch.no_grad()
    def _step(self, h, c, prev_x, tokens: torch.Tensor):
        """Advance rows (h, c, prev_x) [N, ...] by ``tokens`` [N]: returns
        (h2, c2, x, log-softmax of the next-token logits [N, V])."""
        x = self.params["embed"][tokens]
        h2, c2 = _lstm_cell(self.params, h, c,
                            _splice(self.cfg, self.params, prev_x, x))
        return h2, c2, x, torch.log_softmax(
            _output(self.cfg, self.params, h2), dim=-1)

    def initial_state(self):
        """The state after <s>; its embedding stands in for its
        predecessor's in the splice, as the batch path's first frame."""
        h = torch.zeros((1, self.cfg.rec_dim), device=self.device)
        c = torch.zeros((1, self.cfg.hidden_dim), device=self.device)
        bos = self._tensor([self.cfg.bos])
        h, c, px, lp = self._step(h, c, self.params["embed"][bos], bos)
        return (h[0], c[0], px[0], lp[0].cpu().numpy())

    def advance(self, state, word: int):
        """(ln P(word | prefix), the state after consuming word)."""
        h, c, px, lp = state
        h2, c2, px2, lp2 = self._step(h[None], c[None], px[None],
                                      self._tensor([int(word)]))
        return float(lp[int(word)]), (h2[0], c2[0], px2[0],
                                      lp2[0].cpu().numpy())

    def final_logprob(self, state) -> float:
        """ln P(</s> | prefix)."""
        return float(state[-1][self.cfg.eos])

    # -- frontier-batched API (decode/lattice.rescore_lattices_rnnlm) ----
    # Device rows (h [N, R], c [N, H], px [N, E]) without the softmax: one
    # call advances a whole frontier, and one host fetch brings back the
    # consumed words' and </s>'s log-probs.

    def initial_state_batch(self):
        """Device (h, c, px) for the <s> prefix, rows [1, ...]."""
        h, c, px, _ = self.initial_state()
        return h[None], c[None], px[None]

    @torch.no_grad()
    def advance_batch(self, h, c, px, words):
        """Advance N rows by N words (numpy or a device tensor; -1, a
        final arc, reads word 0) in one call.

        Returns (h2, c2, px2) on the device and host arrays (lp_w [N],
        lp_eos [N]): ln P(word_i | prefix_i) under the pre-advance
        distributions, and ln P(</s> | prefix_i), fetched together."""
        w = (words if isinstance(words, torch.Tensor)
             else self._tensor(words)).clamp(min=0)
        lp_all = torch.log_softmax(_output(self.cfg, self.params, h), dim=-1)
        lp = torch.stack([torch.gather(lp_all, 1, w[:, None])[:, 0],
                          lp_all[:, self.cfg.eos]])
        x = self.params["embed"][w]
        h2, c2 = _lstm_cell(self.params, h, c,
                            _splice(self.cfg, self.params, px, x))
        lp = lp.cpu().numpy()
        return h2, c2, x, lp[0], lp[1]


def reverse_sentences(sents: Sequence[Sequence[int]]):
    """Word-reversed corpus for a backward LM (the reference's `_back_`
    recipe trains kaldi-rnnlm on reversed text)."""
    return [list(s)[::-1] for s in sents]


class BidirectionalRnnLMScorer:
    """Interpolated forward + backward RNNLM sentence scorer: ``backward``
    was trained on ``reverse_sentences(corpus)`` and scores the reversed
    hypothesis; ``score()`` is log10, interp * fwd + (1 - interp) * bwd."""

    def __init__(self, forward: RnnLMScorer, backward: RnnLMScorer,
                 interp: float = 0.5):
        if not 0.0 <= interp <= 1.0:
            raise ValueError(f"interp {interp} outside [0, 1]")
        self.forward = forward
        self.backward = backward
        self.interp = interp

    def score(self, words: Sequence[int]) -> float:
        f = self.forward.score(words)
        b = self.backward.score(list(words)[::-1])
        return self.interp * f + (1.0 - self.interp) * b
