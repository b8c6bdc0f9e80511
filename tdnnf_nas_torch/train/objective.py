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
                                        FactoredDenGraph, SparseDenGraph,
                                        forward_score, forward_score_blocked,
                                        forward_score_factored,
                                        forward_score_linear,
                                        forward_score_sparse)


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
    # (the recursion stays float32); the factored, sparse and dense dens
    # take float32 observations, as in the reference
    den_obs_bf16: bool = False


def chain_objective(
    chain_out: torch.Tensor,
    xent_out: torch.Tensor,
    den: Union[BlockedDenGraph, FactoredDenGraph, SparseDenGraph,
               DenGraphArrays],
    sup: ChunkSupervision,
    cfg: ChainObjectiveConfig,
    mesh=None,
):
    """(loss, metrics) for [B, T, P] head outputs and a batched
    supervision of device tensors.  Metrics are detached tensors.

    With a data-parallel ``mesh`` (``parallel.mesh.make_mesh``) the batch
    is this rank's rows of the global batch: the loss is this rank's sum
    over the global frame count, so the ranks' gradients add up to the
    global batch's, and the metrics are all-reduced to the global
    batch's values."""
    if not isinstance(den, (BlockedDenGraph, FactoredDenGraph,
                            SparseDenGraph, DenGraphArrays)):
        raise TypeError(f"{type(den).__name__} is not a denominator graph "
                        "(BlockedDenGraph, FactoredDenGraph, SparseDenGraph "
                        "or DenGraphArrays)")
    b, t, _ = chain_out.shape
    world = 1 if mesh is None else mesh.size
    n_frames = b * t * world

    if isinstance(den, BlockedDenGraph):
        logz_den = forward_score_blocked(chain_out, den,
                                         leaky_coef=cfg.leaky_hmm_coef,
                                         obs_bf16=cfg.den_obs_bf16)
    elif isinstance(den, FactoredDenGraph):
        logz_den = forward_score_factored(chain_out, den,
                                          leaky_coef=cfg.leaky_hmm_coef)
    elif isinstance(den, SparseDenGraph):
        logz_den = forward_score_sparse(chain_out, den,
                                        leaky_coef=cfg.leaky_hmm_coef)
    else:
        logz_den = pallas_forward_score(
            chain_out, den.trans, den.state_pdf, den.init, den.final,
            leaky_coef=cfg.leaky_hmm_coef)

    # Numerator: logZ_num and its gradient gamma (= occupancy posteriors)
    # on a detached copy; a first-order surrogate re-attaches the exact
    # gradient to the graph, and the same gamma serves as xent targets.
    out_sg = chain_out.detach()
    with torch.enable_grad():
        o = out_sg.requires_grad_(True)
        if sup.next_w is not None:
            logz_num = forward_score_linear(o, sup.next_w, sup.state_pdf,
                                            sup.init, sup.final, sup.mask,
                                            sup.self_loop_prob)
        else:  # the dense [B, S, S] numerator graphs
            logz_num = forward_score(o, sup.trans, sup.state_pdf, sup.init,
                                     sup.final, mask=sup.mask)
        gamma, = torch.autograd.grad(logz_num.sum(), o)
    logz_num = logz_num.detach()
    out_sg = out_sg.detach()
    logz_num_sur = ((gamma * chain_out).sum(dim=(1, 2))
                    + (logz_num - (gamma * out_sg).sum(dim=(1, 2))))

    mmi = (logz_num_sur.sum() - logz_den.sum()) / n_frames
    loss = -mmi
    metrics = {
        "objf_mmi": mmi.detach(),
        "logz_num": logz_num.mean() / world / t,
        "logz_den": logz_den.detach().mean() / world / t,
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
    if mesh is not None:
        metrics = mesh.all_reduce_metrics(metrics)
    return loss, metrics
