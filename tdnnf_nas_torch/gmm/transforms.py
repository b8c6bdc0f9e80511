"""Port of ``tdnnf_nas_tpu.gmm.transforms``: feature-space transforms of
the GMM ladder: splicing, LDA, MLLT (global semi-tied covariance) and
per-speaker fMLLR (CMLLR).

The statistics, products over all frames, run as batched torch on the
features' device (the card by default): class sums as segment sums over
frames sorted by class, scatter matrices as batched products.  The small
solves that follow stay on the host in numpy, as the reference writes
them: LDA's two symmetric eigendecompositions (dimension of the spliced
features), MLLT's and fMLLR's row-wise cofactor updates (dimension <= 40,
one row at a time).  A float32 feature's raw scatter is a float32 product
per utterance added into float64, as numpy promotes ``x.T @ x``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.gmm.gmm import (as_tensor, f64, segment_sum, sorted_by,
                                     sq64)

_FRAME_CHUNK = 8192


def splice_frames(feats, context: int = 3, device=DEFAULT_DEVICE):
    """[T, D] -> [T, D*(2*context+1)] with edge replication."""
    x = as_tensor(feats, _dev(feats, device))
    t = x.shape[0]
    base = torch.arange(t, device=x.device)
    return torch.cat([x[torch.clamp(base + off, 0, t - 1)]
                      for off in range(-context, context + 1)], dim=1)


def splice_utterances(feats_list: Sequence[torch.Tensor],
                      context: int) -> List[torch.Tensor]:
    """``splice_frames`` of every utterance, as one gather per offset over
    the concatenated frames (edges replicated within each utterance)."""
    x = torch.cat(list(feats_list))
    lens = np.asarray([f.shape[0] for f in feats_list], np.int64)
    off = np.repeat(np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    pos = np.arange(len(off)) - off
    last = np.repeat(lens - 1, lens)
    cols = [x[torch.as_tensor(np.clip(pos + o, 0, last) + off,
                              device=x.device)]
            for o in range(-context, context + 1)]
    return list(torch.split(torch.cat(cols, dim=1), lens.tolist()))


def _dev(x, device):
    return x.device if isinstance(x, torch.Tensor) else resolve_device(device)


def _frames(feats_list, class_ids_list, device):
    """(frames [F, D] sorted by class, class lengths [K] host, raw frames
    list on the device, class ids [F] host in frame order)."""
    dev = _dev(feats_list[0], device)
    xs = [as_tensor(x, dev) for x in feats_list]
    c = np.concatenate([np.asarray(ci, np.int64) for ci in class_ids_list])
    return xs, c, dev


def _class_stats(feats_list, class_ids_list, num_classes: int,
                 device=DEFAULT_DEVICE):
    """Per-class (count, sum) and the global raw scatter (host numpy)."""
    xs, c, dev = _frames(feats_list, class_ids_list, device)
    order, lengths = sorted_by(c, num_classes)
    x = torch.cat(xs)
    sums = segment_sum(f64(x)[torch.as_tensor(order, device=dev)], lengths)
    # x.T @ x per utterance in x's dtype (numpy's promotion), then float64
    t_max = max(v.shape[0] for v in xs)
    pad = torch.stack([F.pad(v, (0, 0, 0, t_max - v.shape[0])) for v in xs])
    scatter = f64(pad.transpose(1, 2) @ pad).sum(dim=0)
    return (lengths.astype(np.float64), sums.cpu().numpy(),
            scatter.cpu().numpy())


def estimate_lda(feats_list, class_ids_list, num_classes: int, out_dim: int,
                 device=DEFAULT_DEVICE) -> np.ndarray:
    """LDA transform [out_dim, D] (host numpy) from per-frame class labels
    (aligned GMM-HMM states, Kaldi's acc-lda); rows scaled so the projected
    within-class covariance is identity (lda-est's default)."""
    counts, sums, total_scatter = _class_stats(feats_list, class_ids_list,
                                               num_classes, device)
    n = counts.sum()
    mean = sums.sum(axis=0) / n
    # between-class scatter
    nz = counts > 0
    mu_c = sums[nz] / counts[nz][:, None]
    diff = mu_c - mean
    sb = (counts[nz][:, None] * diff).T @ diff / n
    st = total_scatter / n - np.outer(mean, mean)
    sw = st - sb
    sw += 1e-5 * np.trace(sw) / sw.shape[0] * np.eye(sw.shape[0])
    # the generalized eigenproblem via the symmetric whitening trick
    evals_w, evecs_w = np.linalg.eigh(sw)
    w_inv_half = evecs_w @ np.diag(1.0 / np.sqrt(np.maximum(evals_w, 1e-10))) \
        @ evecs_w.T
    m = w_inv_half @ sb @ w_inv_half
    evals, evecs = np.linalg.eigh(m)
    order = np.argsort(evals)[::-1][:out_dim]
    return (evecs[:, order].T @ w_inv_half).astype(np.float64)


def _gmm_state_stats(feats_list, class_ids_list, num_classes: int,
                     device=DEFAULT_DEVICE):
    """Per-class count/mean/diag-var (single Gaussian per class), host."""
    xs, c, dev = _frames(feats_list, class_ids_list, device)
    order, lengths = sorted_by(c, num_classes)
    x = torch.cat(xs)[torch.as_tensor(order, device=dev)]
    counts = lengths.astype(np.float64)
    sums = segment_sum(f64(x), lengths).cpu().numpy()
    sqs = segment_sum(sq64(x), lengths).cpu().numpy()
    nz = counts > 0
    means = np.zeros_like(sums)
    variances = np.ones_like(sqs)
    means[nz] = sums[nz] / counts[nz][:, None]
    variances[nz] = np.maximum(sqs[nz] / counts[nz][:, None] - means[nz]**2,
                               1e-4)
    return counts, means, variances


def estimate_mllt(feats_list, class_ids_list, num_classes: int,
                  num_iters: int = 10,
                  device=DEFAULT_DEVICE) -> Tuple[np.ndarray, List[float]]:
    """Global MLLT / semi-tied covariance transform M [D, D] (host numpy).

    Maximizes sum_c gamma_c * (log|det M| - 0.5 log diag(M S_c M^T)) with
    the row-wise cofactor update (Gopinath 1998; Kaldi est-mllt).  The
    per-class centred scatters S_c are segment sums of outer products over
    all frames on the device; the iterations run on the host.  Returns
    (M, auxiliary objective per iteration)."""
    xs, c, dev = _frames(feats_list, class_ids_list, device)
    d = xs[0].shape[1]
    counts, means, _ = _gmm_state_stats(feats_list, class_ids_list,
                                        num_classes, device)
    order, lengths = sorted_by(c, num_classes)
    cls_sorted = torch.as_tensor(c[order], device=dev)
    x = f64(torch.cat(xs)[torch.as_tensor(order, device=dev)])
    xc = x - torch.as_tensor(means, device=dev)[cls_sorted]
    s_c = torch.zeros((num_classes, d, d), dtype=torch.float64, device=dev)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    for f0 in range(0, x.shape[0], _FRAME_CHUNK):
        f1 = min(f0 + _FRAME_CHUNK, x.shape[0])
        # per class, the frames of this chunk
        lens = np.clip(np.minimum(starts[1:], f1) - np.maximum(starts[:-1],
                                                               f0), 0, None)
        blk = xc[f0:f1]
        s_c += segment_sum(blk[:, :, None] * blk[:, None, :], lens)
    s_c = s_c.cpu().numpy()
    nz = counts > 0
    s_c[nz] /= counts[nz][:, None, None]
    beta = counts.sum()

    m = np.eye(d)
    aux_hist: List[float] = []

    def aux(m):
        val = beta * np.linalg.slogdet(m)[1]
        for cls in np.nonzero(nz)[0]:
            diag = np.einsum("ij,jk,ik->i", m, s_c[cls], m)
            val -= 0.5 * counts[cls] * np.log(np.maximum(diag, 1e-10)).sum()
        return float(val)

    for _ in range(num_iters):
        # G_i = sum_c gamma_c S_c / sigma2_{c,i}  with sigma2 = (M S_c M^T)_ii
        g = np.zeros((d, d, d))
        for cls in np.nonzero(nz)[0]:
            diag = np.einsum("ij,jk,ik->i", m, s_c[cls], m)
            g += (counts[cls] / np.maximum(diag, 1e-10))[:, None, None] \
                * s_c[cls][None]
        for i in range(d):
            cof = np.linalg.inv(m).T[i] * np.linalg.det(m)  # cofactor row
            gi_inv = np.linalg.inv(g[i] + 1e-8 * np.eye(d))
            scale = np.sqrt(beta / max(cof @ gi_inv @ cof, 1e-20))
            m[i] = scale * (cof @ gi_inv)
        aux_hist.append(aux(m))
    # normalize overall scale (det left free; keep det > 0)
    if np.linalg.det(m) < 0:
        m[0] = -m[0]
    return m, aux_hist


def _fmllr_stats(feats_list, post_means, post_invvars,
                 device=DEFAULT_DEVICE):
    """(k [D, D+1], g [D, D+1, D+1], beta) of one speaker's frames, on the
    device: k = sum (mu*iv)^T x+, G_i = x+^T diag(iv_i) x+ (x+ = [x, 1])."""
    dev = _dev(feats_list[0], device)
    x = f64(torch.cat([as_tensor(v, dev) for v in feats_list]))
    mu = f64(torch.cat([as_tensor(v, dev) for v in post_means]))
    iv = f64(torch.cat([as_tensor(v, dev) for v in post_invvars]))
    t, d = x.shape
    xp = torch.cat([x, torch.ones((t, 1), dtype=x.dtype, device=dev)], dim=1)
    k = (mu * iv).T @ xp
    g = torch.zeros((d, (d + 1) ** 2), dtype=x.dtype, device=dev)
    for f0 in range(0, t, _FRAME_CHUNK):
        xc = xp[f0:f0 + _FRAME_CHUNK]
        xsq = (xc[:, :, None] * xc[:, None, :]).reshape(xc.shape[0], -1)
        g += iv[f0:f0 + _FRAME_CHUNK].T @ xsq
    return (k.cpu().numpy(), g.reshape(d, d + 1, d + 1).cpu().numpy(),
            float(t))


def estimate_fmllr(feats_list, post_means, post_invvars, num_iters: int = 5,
                   device=DEFAULT_DEVICE) -> np.ndarray:
    """Per-speaker fMLLR (CMLLR) transform W = [A b] ([D, D+1], host
    numpy), maximizing Q(W) = beta log|det A| - 0.5 sum_t (W x+_t -
    mu_t)^T Sigma_t^{-1} (W x+_t - mu_t) by the row-wise update (Gales 1998
    §3; Kaldi fmllr-diag-gmm).  Inputs: the speaker's utterances and each
    frame's aligned Gaussian's mean and inverse variance.  The statistics
    come from the device (``_fmllr_stats``); the row updates run on the
    host."""
    k, g, beta = _fmllr_stats(feats_list, post_means, post_invvars, device)
    d = k.shape[0]
    w = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    gi_inv = [np.linalg.inv(g[i] + 1e-6 * np.eye(d + 1)) for i in range(d)]
    for _ in range(num_iters):
        for i in range(d):
            a = w[:, :d]
            cof = np.concatenate([np.linalg.inv(a).T[i] * np.linalg.det(a),
                                  [0.0]])
            # stationary point: w_i = (alpha*cof + k_i) G_i^{-1} with alpha
            # from qa*alpha^2 + qb*alpha - beta = 0 (alpha = beta/det A)
            p = gi_inv[i] @ cof
            qa = cof @ p
            qb = k[i] @ p
            disc = qb * qb + 4.0 * qa * beta
            if qa <= 0 or disc <= 0:
                continue
            alpha = (-qb + np.sqrt(disc)) / (2.0 * qa)
            w[i] = (alpha * cof + k[i]) @ gi_inv[i]
    return w


def apply_fmllr(feats, w, device=DEFAULT_DEVICE) -> torch.Tensor:
    """[T, D] x W [D, D+1] -> [T, D] (float64, on the features' device)."""
    x = as_tensor(feats, _dev(feats, device))
    wt = torch.as_tensor(np.asarray(w, np.float64), device=x.device)
    return f64(x) @ wt[:, :-1].T + wt[:, -1]


def fmllr_auxf(feats_list, post_means, post_invvars, w,
               device=DEFAULT_DEVICE) -> float:
    """Per-frame fMLLR auxiliary objective (tests, diagnostics)."""
    d = w.shape[0]
    total, frames = 0.0, 0
    logdet = np.linalg.slogdet(w[:, :d])[1]
    for x, mu, iv in zip(feats_list, post_means, post_invvars):
        dev = _dev(x, device)
        y = apply_fmllr(x, w, dev)
        e = (y - f64(as_tensor(mu, dev))) ** 2 * f64(as_tensor(iv, dev))
        total += x.shape[0] * logdet - 0.5 * float(e.sum())
        frames += x.shape[0]
    return total / max(frames, 1)
