"""The LF-MMI (chain) objective (port of ``tdnnf_nas_tpu.train.objective``).

  objf = (1/N) * sum_b [ logZ_num(b) - logZ_den(b) ]
         - l2 * ||chain_out||^2 / (2N)
         + xent_scale * (1/N) * sum gamma_num * log_softmax(xent_out)

with N = total supervised frames, leaky-HMM on the denominator only and
the numerator posteriors gamma_num (no gradient) as the xent head's soft
targets.  The returned loss is -objf.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.graphs.supervision import ChunkSupervision
from tdnnf_nas_torch.ops.dense_den_cuda import pallas_forward_score
from tdnnf_nas_torch.ops.fwdbwd import (BlockedDenGraph, DenGraphArrays,
                                        forward_score_blocked,
                                        forward_score_linear)


@dataclasses.dataclass(frozen=True)
class ChainObjectiveConfig(Config):
    xent_regularize: float = 0.1
    leaky_hmm_coef: float = 0.1
    out_l2_regularize: float = 0.0  # Kaldi --chain.l2-regularize (on outputs)
    # the reference's switch to its Pallas dense-den kernel, kept so its
    # configs carry across; the port ignores it: a dense den always scans
    # with the hand-written kernels (ops/dense_den_cuda.py), whose plain
    # versions serve the CPU
    pallas_den: bool = False
    # keep the expanded per-slot observations of the blocked den in bf16
    # (the recursion stays float32)
    den_obs_bf16: bool = False


def chain_objective(
    chain_out: torch.Tensor,
    xent_out: torch.Tensor,
    den: Union[BlockedDenGraph, DenGraphArrays],
    sup: ChunkSupervision,
    cfg: ChainObjectiveConfig,
):
    """(loss, metrics) for [B, T, P] head outputs and a batched
    supervision of device tensors.  Metrics are detached tensors."""
    if not isinstance(den, (BlockedDenGraph, DenGraphArrays)):
        raise TypeError(
            f"{type(den).__name__} denominators are not ported; the port "
            "takes BlockedDenGraph and DenGraphArrays (the factored and "
            "sparse graphs are not ported yet)")
    if sup.next_w is None:
        raise NotImplementedError(
            "the dense numerator (no next_w) is not ported yet")
    b, t, _ = chain_out.shape
    n_frames = b * t

    if isinstance(den, BlockedDenGraph):
        logz_den = forward_score_blocked(chain_out, den,
                                         leaky_coef=cfg.leaky_hmm_coef,
                                         obs_bf16=cfg.den_obs_bf16)
    else:
        logz_den = pallas_forward_score(
            chain_out, den.trans, den.state_pdf, den.init, den.final,
            leaky_coef=cfg.leaky_hmm_coef, trans_T=den.trans_T)

    # Numerator: logZ_num and its gradient gamma (= occupancy posteriors)
    # on a detached copy; a first-order surrogate re-attaches the exact
    # gradient to the graph, and the same gamma serves as xent targets.
    out_sg = chain_out.detach()
    with torch.enable_grad():
        o = out_sg.requires_grad_(True)
        logz_num = forward_score_linear(o, sup.next_w, sup.state_pdf,
                                        sup.init, sup.final, sup.mask,
                                        sup.self_loop_prob)
        gamma, = torch.autograd.grad(logz_num.sum(), o)
    logz_num = logz_num.detach()
    out_sg = out_sg.detach()
    logz_num_sur = ((gamma * chain_out).sum(dim=(1, 2))
                    + (logz_num - (gamma * out_sg).sum(dim=(1, 2))))

    mmi = (logz_num_sur.sum() - logz_den.sum()) / n_frames
    loss = -mmi
    metrics = {
        "objf_mmi": mmi.detach(),
        "logz_num": logz_num.mean() / t,
        "logz_den": logz_den.detach().mean() / t,
    }
    if cfg.out_l2_regularize > 0.0:
        l2 = torch.square(chain_out).sum() / (2.0 * n_frames)
        loss = loss + cfg.out_l2_regularize * l2
        metrics["out_l2"] = l2.detach()
    if cfg.xent_regularize > 0.0:
        logp = torch.log_softmax(xent_out, dim=-1)
        xent_objf = (gamma * logp).sum() / n_frames
        loss = loss - cfg.xent_regularize * xent_objf
        metrics["objf_xent"] = xent_objf.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics
