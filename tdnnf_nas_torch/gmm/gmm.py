"""Port of ``tdnnf_nas_tpu.gmm.gmm``: diagonal-covariance GMM-HMM acoustic
models, flat-start monophone and tied context-dependent training by Viterbi
EM with mixture splitting (the reference's GMM ladder, `run.sh:139-257`,
which exists only to produce phone alignments for the chain supervision).

The reference runs on the host in numpy, one utterance and, inside the
Viterbi, one frame at a time.  Here the frame work runs as batched torch on
the model's device (the card by default): the per-component
log-likelihoods of every frame are one product, the forced alignment runs
over padded [U, T, N] log-likelihoods of many utterances at once with a
masked two-way max over [U, N] per frame, and the EM statistics are
segment sums over frames sorted by state.  Everything is float64, as
numpy computes it, and a float32 feature is squared in float32 before it
is promoted, as numpy's ``feats**2 @ inv_var.T`` does, so the hard
decisions (``move > stay``, strict) match the reference's.  Mixing up
(``split``) and the tied-state clustering stay on the host: they touch a
few numbers per state.

HMM: per phone, ``states_per_phone`` left-to-right states at the INPUT
frame rate; the ladder converts boundaries to the output rate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device

_NEG = -1e30
_F64 = torch.float64
_LOG_2PI = float(np.log(2 * np.pi))
# padded [U, T, N] log-likelihood elements aligned at once
_ALIGN_BUDGET = 1 << 26
# frames of a gathered [F, M, D] product at once
_FRAME_CHUNK = 1 << 15


def as_tensor(x, device) -> torch.Tensor:
    """x (numpy or tensor) on ``device``, its dtype kept."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(_F64)


def sq64(x: torch.Tensor) -> torch.Tensor:
    """x**2 in x's dtype, then float64 (numpy's order for float32 x)."""
    return (x * x).to(_F64)


def segment_sum(values: torch.Tensor, lengths: np.ndarray) -> torch.Tensor:
    """Sums of consecutive row segments of ``values`` [F, ...] (lengths
    [K] on the host, empty segments give 0): [K, ...].  Deterministic."""
    flat = values.reshape(values.shape[0], -1)
    out = torch.segment_reduce(
        flat, "sum", lengths=torch.as_tensor(lengths, device=values.device),
        axis=0)
    return out.reshape((len(lengths),) + tuple(values.shape[1:]))


def sorted_by(keys: np.ndarray, num_keys: int):
    """(order, lengths): a stable sort of frames by key and the frames per
    key, for ``segment_sum``."""
    order = np.argsort(keys, kind="stable")
    return order, np.bincount(keys, minlength=num_keys)


@dataclasses.dataclass
class DiagGmm:
    """weights [M], means [M, D], variances [M, D] (float64 tensors)."""

    weights: torch.Tensor
    means: torch.Tensor
    variances: torch.Tensor

    @property
    def num_mix(self) -> int:
        return int(self.weights.shape[0])

    def loglike(self, feats: torch.Tensor) -> torch.Tensor:
        """[T, D] -> [T] total log-likelihood (logsumexp over mixtures)."""
        return torch.logsumexp(self.component_loglike(feats), dim=1)

    def component_loglike(self, feats: torch.Tensor) -> torch.Tensor:
        """[T, D] -> [T, M] per-mixture log p(x, m)."""
        d = feats.shape[1]
        inv_var = 1.0 / self.variances
        log_det = torch.log(self.variances).sum(dim=1)
        x2 = sq64(feats) @ inv_var.T
        xm = f64(feats) @ (self.means * inv_var).T
        m2 = ((self.means * self.means) * inv_var).sum(dim=1)
        const = torch.log(torch.clamp(self.weights, min=1e-30)) - 0.5 * (
            d * _LOG_2PI + log_det + m2)
        return const[None, :] + xm - 0.5 * x2


def _split_np(w, mu, var, target: int, perturb: float = 0.1):
    """The reference's ``DiagGmm.split`` on numpy arrays (Kaldi gmm-mixup:
    split the heaviest component along its standard deviation)."""
    w, mu, var = list(w), list(mu), list(var)
    rng = np.random.RandomState(len(w))
    while len(w) < target:
        i = int(np.argmax(w))
        d = perturb * np.sqrt(var[i]) * rng.choice([-1.0, 1.0],
                                                   size=var[i].shape)
        w_half = w[i] / 2.0
        w[i] = w_half
        w.append(w_half)
        mu.append(mu[i] + d)
        mu[i] = mu[i] - d
        var.append(var[i].copy())
    return np.asarray(w), np.asarray(mu), np.asarray(var)


@dataclasses.dataclass
class AmGmm:
    """One diagonal GMM per (tied) HMM state, the states' mixtures padded
    to the largest count: weights [K, M] (0 past a state's ``num_mix``),
    means [K, M, D] (0 past it), variances [K, M, D] (1 past it), float64
    tensors on the model's device; ``num_mix`` [K] on the host.

    Monophone: states indexed (phone, state_in_phone).  Context-dependent
    (tri1/tri2): ``tie_table`` [P, S, P+1] maps (phone, state_in_phone,
    left_phone+1) -> tied state (``train_tri``).  ``gmms`` gives each state
    as a ``DiagGmm`` (views, no copy).
    """

    weights: torch.Tensor
    means: torch.Tensor
    variances: torch.Tensor
    num_mix: np.ndarray
    num_phones: int
    states_per_phone: int
    self_loop_prob: float = 0.7
    tie_table: Optional[np.ndarray] = None  # [P, S, P+1] int64

    @classmethod
    def from_gmms(cls, gmms: Sequence[DiagGmm], num_phones: int,
                  states_per_phone: int, self_loop_prob: float = 0.7,
                  tie_table=None, device=None) -> "AmGmm":
        """Pads a list of per-state DiagGmm (tensors or numpy arrays)."""
        dev = resolve_device(device if device is not None
                             else gmms[0].means.device)
        num_mix = np.asarray([len(g.weights) for g in gmms], np.int64)
        k, m, d = len(gmms), int(num_mix.max()), gmms[0].means.shape[1]
        w = np.zeros((k, m))
        mu = np.zeros((k, m, d))
        var = np.ones((k, m, d))
        for s, g in enumerate(gmms):
            n = num_mix[s]
            w[s, :n] = np.asarray(_host(g.weights), np.float64)
            mu[s, :n] = np.asarray(_host(g.means), np.float64)
            var[s, :n] = np.asarray(_host(g.variances), np.float64)
        return cls(as_tensor(w, dev), as_tensor(mu, dev),
                   as_tensor(var, dev), num_mix, num_phones,
                   states_per_phone, self_loop_prob, tie_table)

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def num_states(self) -> int:
        return int(self.weights.shape[0])

    @property
    def gmms(self) -> List[DiagGmm]:
        return [DiagGmm(self.weights[s, :n], self.means[s, :n],
                        self.variances[s, :n])
                for s, n in enumerate(self.num_mix)]

    def state_index(self, phone: int, state: int, left: int = -1) -> int:
        if self.tie_table is not None:
            return int(self.tie_table[phone, state, left + 1])
        return phone * self.states_per_phone + state

    def _valid(self) -> torch.Tensor:
        m = self.weights.shape[1]
        return torch.as_tensor(np.arange(m)[None, :] < self.num_mix[:, None],
                               device=self.device)

    def _packed(self):
        """(mu*inv_var [K*M, D], inv_var [K*M, D], const [K*M]) with the
        reference's ``_packed`` constants, -inf on padded components."""
        packed = self.__dict__.get("_packed_cache")
        if packed is None:
            d = self.means.shape[2]
            inv_var = 1.0 / self.variances
            const = torch.log(torch.clamp(self.weights, min=1e-30)) - 0.5 * (
                d * _LOG_2PI + torch.log(self.variances).sum(dim=2)
                + ((self.means * self.means) / self.variances).sum(dim=2))
            const = torch.where(self._valid(), const,
                                torch.full_like(const, -np.inf))
            packed = ((self.means * inv_var).reshape(-1, d),
                      inv_var.reshape(-1, d), const.reshape(-1))
            self.__dict__["_packed_cache"] = packed
        return packed

    def loglikes(self, feats: torch.Tensor) -> torch.Tensor:
        """[T, D] -> [T, K]: each state's logsumexp over its mixtures."""
        mu_iv, inv_var, const = self._packed()
        scores = (const[None, :] + f64(feats) @ mu_iv.T
                  - 0.5 * sq64(feats) @ inv_var.T)
        scores = scores.reshape(feats.shape[0], self.num_states, -1)
        mx = scores.amax(dim=2, keepdim=True)
        s = torch.exp(scores - mx).sum(dim=2)
        return mx[:, :, 0] + torch.log(s)

    def own_state_loglike(self, feats: torch.Tensor,
                          states: torch.Tensor) -> torch.Tensor:
        """[F, D] frames and their states [F] -> [F, M]: each frame's
        ``DiagGmm.component_loglike`` under its own state (-inf on padded
        components)."""
        d = self.means.shape[2]
        inv_var = 1.0 / self.variances
        const = torch.log(torch.clamp(self.weights, min=1e-30)) - 0.5 * (
            d * _LOG_2PI + torch.log(self.variances).sum(dim=2)
            + ((self.means * self.means) * inv_var).sum(dim=2))
        const = torch.where(self._valid(), const,
                            torch.full_like(const, -np.inf))
        mu_iv = self.means * inv_var
        out = []
        for f0 in range(0, feats.shape[0], _FRAME_CHUNK):
            x = feats[f0:f0 + _FRAME_CHUNK]
            s = states[f0:f0 + _FRAME_CHUNK]
            x2 = torch.einsum("fd,fmd->fm", sq64(x), inv_var[s])
            xm = torch.einsum("fd,fmd->fm", f64(x), mu_iv[s])
            out.append(const[s] + xm - 0.5 * x2)
        if not out:
            return feats.new_zeros((0, self.weights.shape[1]), dtype=_F64)
        return torch.cat(out)

    def replace(self, **kw) -> "AmGmm":
        """A new model (no cached packing) with fields replaced."""
        fields = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)}
        fields.update(kw)
        return AmGmm(**fields)

    def split(self, target: int, perturb: float = 0.1) -> "AmGmm":
        """Every state mixed up to ``target`` components by the
        reference's ``DiagGmm.split`` (on the host: a few numbers per
        state, its seeded sign draws kept)."""
        w_h = self.weights.cpu().numpy()
        mu_h = self.means.cpu().numpy()
        var_h = self.variances.cpu().numpy()
        parts = [_split_np(w_h[s, :n], mu_h[s, :n], var_h[s, :n], target,
                           perturb) for s, n in enumerate(self.num_mix)]
        gmms = [DiagGmm(*p) for p in parts]
        return AmGmm.from_gmms(gmms, self.num_phones, self.states_per_phone,
                               self.self_loop_prob, self.tie_table,
                               device=self.device)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


@dataclasses.dataclass(frozen=True)
class MonoHmmConfig(Config):
    states_per_phone: int = 3
    self_loop_prob: float = 0.7
    num_iters: int = 12
    max_mix: int = 4
    mix_up_iters: Tuple[int, ...] = (4, 8)  # iterations after which to split
    var_floor: float = 1e-3


def _linear_hmm_arrays(phones: Sequence[int], am: AmGmm) -> np.ndarray:
    """State ids [N] of the linear-chain HMM over the transcript; tied
    models resolve each state with the true left phone."""
    ids = []
    prev = -1
    for p in phones:
        for s in range(am.states_per_phone):
            ids.append(am.state_index(int(p), s, prev))
        prev = int(p)
    return np.asarray(ids, np.int32)


def _align_group(feats: Sequence[torch.Tensor], phone_seqs, am: AmGmm):
    """Forced alignment of a group of utterances at once: padded [U, T, N]
    log-likelihoods, per frame a masked two-way max over [U, N]
    (``move > stay``, strict, as the reference takes it), then the
    backtrace over all rows together."""
    dev = am.device
    ids = [_linear_hmm_arrays(p, am) for p in phone_seqs]
    n_u = np.asarray([len(i) for i in ids], np.int64)
    t_u = np.asarray([f.shape[0] for f in feats], np.int64)
    if (t_u < n_u).any():
        raise ValueError("utterance shorter than its transcript HMM")
    u_count, t_max, n_max = len(feats), int(t_u.max()), int(n_u.max())
    lls = am.loglikes(torch.cat(list(feats)))  # [F, K]
    off = np.concatenate([[0], np.cumsum(t_u)[:-1]])
    rows = (np.minimum(np.arange(t_max)[None, :], t_u[:, None] - 1)
            + off[:, None])
    ids_pad = np.zeros((u_count, n_max), np.int64)
    for u, i in enumerate(ids):
        ids_pad[u, : len(i)] = i
    ll = lls[torch.as_tensor(rows, device=dev)[:, :, None],
             torch.as_tensor(ids_pad, device=dev)[:, None, :]]
    log_self = float(np.log(am.self_loop_prob))
    log_next = float(np.log(1.0 - am.self_loop_prob))
    t_len = torch.as_tensor(t_u, device=dev)
    delta = torch.full((u_count, n_max), _NEG, dtype=_F64, device=dev)
    delta[:, 0] = ll[:, 0, 0]
    bp = torch.zeros((u_count, t_max, n_max), dtype=torch.bool, device=dev)
    neg = torch.full((u_count, 1), _NEG, dtype=_F64, device=dev)
    for t in range(1, t_max):
        stay = delta + log_self
        move = torch.cat([neg, delta[:, :-1] + log_next], dim=1)
        take = move > stay
        bp[:, t] = take
        new = torch.where(take, move, stay) + ll[:, t]
        delta = torch.where((t_len > t)[:, None], new, delta)
    n_last = torch.as_tensor(n_u - 1, device=dev)
    ar = torch.arange(u_count, device=dev)
    scores = delta[ar, n_last].cpu().numpy()
    path = torch.zeros((u_count, t_max), dtype=torch.int64, device=dev)
    cur = n_last.clone()
    for t in range(t_max - 1, -1, -1):
        path[:, t] = cur
        if t > 0:
            cur = cur - (bp[ar, t, cur] & (t_len > t)).long()
    path = path.cpu().numpy()
    return ([path[u, : t_u[u]].astype(np.int32) for u in range(u_count)],
            [float(s) for s in scores])


def align_utterances(feats_list: Sequence[torch.Tensor], phone_seqs,
                     am: AmGmm) -> Tuple[List[np.ndarray], List[float]]:
    """``viterbi_align_gmm`` of every utterance, batched: utterances in
    consecutive groups whose padded [U, T, N] stays within a budget."""
    paths, scores = [], []
    i = 0
    n = len(feats_list)
    while i < n:
        j, t_max, n_max = i, 0, 0
        while j < n:
            t2 = max(t_max, feats_list[j].shape[0])
            n2 = max(n_max, am.states_per_phone * len(phone_seqs[j]))
            if j > i and (j - i + 1) * t2 * n2 > _ALIGN_BUDGET:
                break
            t_max, n_max, j = t2, n2, j + 1
        p, s = _align_group(feats_list[i:j], phone_seqs[i:j], am)
        paths += p
        scores += s
        i = j
    return paths, scores


def viterbi_align_gmm(feats, phones: Sequence[int],
                      am: AmGmm) -> Tuple[np.ndarray, float]:
    """Forced alignment: [T] linear-HMM state indices (into the transcript
    chain, NOT am state ids) + total log-likelihood."""
    paths, scores = _align_group([as_tensor(feats, am.device)], [phones], am)
    return paths[0], scores[0]


def _uniform_align(t_len: int, n_states: int) -> np.ndarray:
    """Flat-start: evenly split frames across the transcript chain."""
    edges = np.linspace(0, t_len, n_states + 1)
    path = np.zeros((t_len,), np.int32)
    for i in range(n_states):
        path[int(edges[i]): max(int(edges[i + 1]), int(edges[i]) + 1)] = i
    # monotone non-decreasing and ends at n_states-1
    path = np.minimum.accumulate(path[::-1])[::-1]
    path[-1] = n_states - 1
    return path


def _accumulate_and_update(am: AmGmm, feats_list, phone_seqs, paths,
                           var_floor: float) -> AmGmm:
    """One EM step: hard state assignment, soft mixture posteriors within
    the state; every state's statistics are segment sums over all frames
    sorted by state (in utterance and frame order, as the reference
    gathers them).  A state without frames, or whose every component
    keeps gamma <= 1e-2, keeps its GMM."""
    k, dev = am.num_states, am.device
    states = np.concatenate([_linear_hmm_arrays(ph, am)[p]
                             for ph, p in zip(phone_seqs, paths)]
                            ).astype(np.int64)
    order, counts = sorted_by(states, k)
    x = torch.cat([as_tensor(f, dev) for f in feats_list])[
        torch.as_tensor(order, device=dev)]
    lp = am.own_state_loglike(x, torch.as_tensor(states[order], device=dev))
    lp = lp - lp.amax(dim=1, keepdim=True)
    post = torch.exp(lp)
    post = post / post.sum(dim=1, keepdim=True)
    gamma = segment_sum(post, counts)  # [K, M]
    mu = segment_sum(post[:, :, None] * f64(x)[:, None, :], counts)
    ex2 = segment_sum(post[:, :, None] * sq64(x)[:, None, :], counts)
    keep = gamma > 1e-2
    safe = torch.where(keep, gamma, torch.ones_like(gamma))[:, :, None]
    mu = mu / safe
    ex2 = ex2 / safe
    var = torch.clamp(ex2 - mu * mu, min=var_floor)
    w = gamma / torch.where(keep, gamma, torch.zeros_like(gamma)).sum(
        dim=1, keepdim=True).clamp(min=1e-300)
    # per state: its kept components in order, or all of its old ones
    keep_h = keep.cpu().numpy()
    m_new = gamma.shape[1]
    sources, num_mix = [], np.zeros((k,), np.int64)
    for s in range(k):
        kept = np.nonzero(keep_h[s])[0]
        if counts[s] == 0 or len(kept) == 0:
            src = m_new + np.arange(am.num_mix[s])
        else:
            src = kept
        sources.append(src)
        num_mix[s] = len(src)
    m_out = int(num_mix.max())
    sel = np.zeros((k, m_out), np.int64)
    for s, src in enumerate(sources):
        sel[s, : len(src)] = src
    valid = torch.as_tensor(np.arange(m_out)[None, :] < num_mix[:, None],
                            device=dev)
    idx = torch.as_tensor(sel, device=dev)
    d = am.means.shape[2]

    def pick(new, old, fill):
        both = torch.cat([new, old], dim=1)
        ix = idx if both.ndim == 2 else idx[:, :, None].expand(-1, -1, d)
        out = torch.gather(both, 1, ix)
        v = valid if both.ndim == 2 else valid[:, :, None]
        return torch.where(v, out, torch.full_like(out, fill))

    return am.replace(weights=pick(w, am.weights, 0.0),
                      means=pick(mu, am.means, 0.0),
                      variances=pick(var, am.variances, 1.0),
                      num_mix=num_mix)


def train_mono(
    feats_list: Sequence,
    phone_seqs: Sequence[Sequence[int]],
    num_phones: int,
    cfg: MonoHmmConfig = MonoHmmConfig(),
    init_am: Optional[AmGmm] = None,
    device=DEFAULT_DEVICE,
) -> Tuple[AmGmm, List[np.ndarray], List[float]]:
    """Flat-start Viterbi-EM monophone training (or EM from ``init_am``,
    on its device).  Returns (model, final alignments [T] state-chain
    paths per utterance, per-iteration mean log-likelihood)."""
    dev = init_am.device if init_am is not None else resolve_device(device)
    feats_list = [as_tensor(f, dev) for f in feats_list]
    if init_am is None:
        # global-stats single-Gaussian init
        allx = f64(torch.cat(feats_list))
        g_mu = allx.mean(dim=0)
        g_var = torch.clamp(allx.var(dim=0, unbiased=False),
                            min=cfg.var_floor)
        k = num_phones * cfg.states_per_phone
        am = AmGmm(torch.ones((k, 1), dtype=_F64, device=dev),
                   g_mu[None, None].expand(k, 1, -1).clone(),
                   g_var[None, None].expand(k, 1, -1).clone(),
                   np.ones((k,), np.int64), num_phones,
                   cfg.states_per_phone, cfg.self_loop_prob)
        # one flat-start update so states differ before the first alignment
        paths = [_uniform_align(f.shape[0], cfg.states_per_phone * len(p))
                 for f, p in zip(feats_list, phone_seqs)]
        am = _accumulate_and_update(am, feats_list, phone_seqs, paths,
                                    cfg.var_floor)
    else:
        am = init_am

    lls: List[float] = []
    paths = []
    mix = 1
    for it in range(cfg.num_iters):
        paths, scores = align_utterances(feats_list, phone_seqs, am)
        total, frames = 0.0, 0
        for f, s in zip(feats_list, scores):
            total += s
            frames += f.shape[0]
        lls.append(total / max(frames, 1))
        am = _accumulate_and_update(am, feats_list, phone_seqs, paths,
                                    cfg.var_floor)
        if it in cfg.mix_up_iters and mix < cfg.max_mix:
            mix = min(mix * 2, cfg.max_mix)
            am = am.split(mix)
    return am, paths, lls


def train_tri(
    feats_list: Sequence,
    phone_seqs: Sequence[Sequence[int]],
    num_phones: int,
    cfg: MonoHmmConfig,
    init_am: AmGmm,
    num_leaves: int,
    min_count: float = 3.0,
) -> Tuple[AmGmm, List[np.ndarray], List[float]]:
    """Context-dependent GMM training (tri1/tri2, steps/train_deltas.sh):
    tie (phone, hmm-state, left-phone) triples by likelihood clustering of
    frame stats from ``init_am``'s alignments (the stats are segment sums
    on the model's device; the clustering runs on the host), then Viterbi
    EM with mixture splitting.  Returns (tied model, alignments,
    per-iteration log-likelihood)."""
    from tdnnf_nas_torch.graphs.tree_cluster import _cluster_contexts

    dev = init_am.device
    feats_list = [as_tensor(f, dev) for f in feats_list]
    d = feats_list[0].shape[1]
    s_per = init_am.states_per_phone
    rows = num_phones * s_per  # cluster within each (phone, hmm-state)
    n_ctx = num_phones + 1
    paths, _ = align_utterances(feats_list, phone_seqs, init_am)
    keys = []
    for phones, path in zip(phone_seqs, paths):
        # chain-state -> (phone idx, state-in-phone, left phone)
        phone_of = np.repeat(np.arange(len(phones)), s_per)[path]
        state_of = path % s_per
        lefts = np.asarray([-1] + list(phones[:-1]))
        r = np.asarray(phones)[phone_of] * s_per + state_of
        keys.append(r * n_ctx + lefts[phone_of] + 1)
    keys = np.concatenate(keys).astype(np.int64)
    order, lengths = sorted_by(keys, rows * n_ctx)
    x = torch.cat(feats_list)[torch.as_tensor(order, device=dev)]
    counts = lengths.astype(np.float64).reshape(rows, n_ctx)
    sums = segment_sum(f64(x), lengths).cpu().numpy().reshape(rows, n_ctx, d)
    sumsqs = segment_sum(sq64(x), lengths).cpu().numpy().reshape(
        rows, n_ctx, d)
    table, n_tied = _cluster_contexts(counts, sums, sumsqs, num_leaves,
                                      min_count=min_count)
    tie_table = np.asarray(table, np.int64).reshape(num_phones, s_per, n_ctx)

    # initialize tied GMMs from their cluster stats (single Gaussian)
    flat = tie_table.reshape(rows, n_ctx)
    gmms: List[DiagGmm] = []
    for g in range(n_tied):
        sel = flat == g
        n = counts[sel].sum()
        if n < 1e-8:
            gmms.append(DiagGmm(np.ones((1,)), np.zeros((1, d)),
                                np.ones((1, d))))
            continue
        mu = sums[sel].sum(axis=0) / n
        var = np.maximum(sumsqs[sel].sum(axis=0) / n - mu * mu,
                         cfg.var_floor)
        gmms.append(DiagGmm(np.ones((1,)), mu[None], var[None]))
    am = AmGmm.from_gmms(gmms, num_phones, s_per, init_am.self_loop_prob,
                         tie_table=tie_table, device=dev)
    return train_mono(feats_list, phone_seqs, num_phones, cfg, init_am=am)


def corpus_loglike(am: AmGmm, feats_list: Sequence,
                   phone_seqs: Sequence[Sequence[int]]) -> float:
    """Mean per-frame forced-alignment log-likelihood over the corpus."""
    feats_list = [as_tensor(f, am.device) for f in feats_list]
    _, scores = align_utterances(feats_list, phone_seqs, am)
    total, frames = 0.0, 0
    for f, s in zip(feats_list, scores):
        total += s
        frames += f.shape[0]
    return total / max(frames, 1)


def path_to_phone_bounds(
    path: np.ndarray, phones: Sequence[int], states_per_phone: int
) -> Tuple[List[int], List[int]]:
    """Chain-state path -> (begins, ends) per phone, input-frame rate."""
    phone_of_chain = np.repeat(np.arange(len(phones)), states_per_phone)
    phone_idx = phone_of_chain[path]
    begins, ends = [], []
    for i in range(len(phones)):
        where = np.nonzero(phone_idx == i)[0]
        begins.append(int(where[0]))
        ends.append(int(where[-1]))
    return begins, ends
