"""Fork-extra primitive ops (port of ``tdnnf_nas_tpu.ops.extras``): the
reference's secondary nnet3 components (the author's BLHUC/Bayes
adaptation line, registered at `nnet-component-itf.cc:224-274` but off
the NAS path).  Each is a small function; the Bayes/GP model family
(`models/bayes.py`) composes the variational ones.

Mapping:
  NormalRandComponent        -> normal_rand
  MinValueComponent          -> min_value
  ExpComponent               -> torch.exp (trivial; listed for inventory)
  SoftmaxgradnormComponent   -> softmax_gradnorm
  InputVectorLinearComponent -> input_vector_linear
  LinearSelectColComponent   -> linear_select_col
  BayesVecKLGaussianComponent-> sample_vec_and_kl
  KLGaussianComponent        -> models/bayes.gaussian_kl (analytic)
  GumbelSoftmaxComponent     -> gumbel_softmax (also models/nas.branch_coefs)
  ArgmaxOnehotFunctionComponent -> argmax_onehot_st

The random ops draw from an explicit ``torch.Generator`` on the input's
device, or take the draw itself (``noise``), which is how the parity
tests feed in the JAX package's draws (the ``models/nas.draw_noise``
convention).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device


def _need(noise, generator, what):
    if noise is None and generator is None:
        raise ValueError(f"{what} needs a generator or its noise")


def normal_rand(batch: int, dim: int,
                generator: Optional[torch.Generator] = None,
                rand_per_frame: bool = True, device=DEFAULT_DEVICE,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`NormalRandComponent` (`nnet-simple-component.h:2077-2115`): emit
    N(0,1) noise, ignoring the input; one shared row when not per-frame.
    ``noise``: the draw itself, [batch, dim] (or [1, dim] when not
    per-frame)."""
    dev = resolve_device(device)
    _need(noise, generator, "normal_rand")
    shape = (batch, dim) if rand_per_frame else (1, dim)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=dev)
    return noise.expand(batch, dim)


class _MinValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return scale * x

    @staticmethod
    def backward(ctx, g):
        # the reference ignores the incoming deriv and sets -scale
        return torch.full_like(g, -ctx.scale), None


def min_value(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """`MinValueComponent` (`nnet-simple-component.cc:4872-4891`): forward
    is scale*x; the gradient to x is the CONSTANT -scale, whatever comes
    in: attached to a graph output it makes training minimize x directly
    (an objective injector, like the FLOPs components)."""
    return _MinValue.apply(x, scale)


class _SoftmaxGradnorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.softmax(x, dim=-1)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        d = y * (g - torch.sum(y * g, dim=-1, keepdim=True))
        return d * (100.0 / y.shape[-1])


def softmax_gradnorm(x: torch.Tensor) -> torch.Tensor:
    """`SoftmaxgradnormComponent` (`nnet-simple-component.cc:9684-9736`):
    row softmax whose input-gradient is rescaled by 100/num_cols."""
    return _SoftmaxGradnorm.apply(x)


def input_vector_linear(linear: torch.Tensor, gains: torch.Tensor,
                        sizes: Sequence[int]) -> torch.Tensor:
    """`InputVectorLinearComponent` (`nnet-simple-component.cc:5379-5420`):
    per-frame gains (tiled across the linear features) multiply the linear
    part elementwise; output dim j sums a contiguous column range of size
    sizes[j].

    linear: [..., sum(sizes)]; gains: [..., G] with G dividing sum(sizes).
    """
    total = int(np.sum(sizes))
    if linear.shape[-1] != total:
        raise ValueError(f"linear has {linear.shape[-1]} columns, sizes sum "
                         f"to {total}")
    reps = total // gains.shape[-1]
    prod = linear * gains.repeat((1,) * (gains.ndim - 1) + (reps,))
    segs = np.repeat(np.arange(len(sizes)), np.asarray(sizes))
    onehot = torch.as_tensor(
        (segs[:, None] == np.arange(len(sizes))[None, :]).astype(np.float32),
        device=linear.device)
    return prod @ onehot


def linear_select_col(ids: torch.Tensor, params: torch.Tensor
                      ) -> torch.Tensor:
    """`LinearSelectColComponent` (`nnet-simple-component.cc:10355-10390`):
    per-frame integer id selects a column of the trainable matrix (an
    embedding lookup along columns).

    ids: [B] int; params: [D, N] -> out [B, D]."""
    return params[:, ids.long()].T


def gumbel_softmax(logits: torch.Tensor, tau,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`GumbelSoftmaxComponent` (`nnet-simple-component.cc:9738-9855`):
    softmax((logits + G)/tau), G = -log(-log U), U ~ U[1e-20, 1) from
    ``generator``, or ``noise`` = U itself."""
    _need(noise, generator, "gumbel_softmax")
    u = noise
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device).clamp(min=1e-20)
    g = -torch.log(-torch.log(u))
    return torch.softmax((logits + g) / tau, dim=-1)


def argmax_onehot_st(logits: torch.Tensor) -> torch.Tensor:
    """`ArgmaxOnehotFunctionComponent` (`nnet-simple-component.cc:
    9859-9928`): hard argmax one-hot forward, straight-through (identity)
    gradient."""
    hard = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).to(logits.dtype)
    return logits + (hard - logits).detach()


def sample_vec_and_kl(
    post_mean: torch.Tensor,
    post_std: torch.Tensor,
    prior_mean: torch.Tensor,
    prior_std: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    rand_per_frame: bool = False,
    test_mode: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`BayesVecKLGaussianComponent` (`nnet-simple-component.cc:
    10536-10640`): per-frame latent draw z = post_mean + post_std*eps (eps
    shared across frames unless rand_per_frame; z = post_mean in test
    mode) plus the per-frame KL(q||p) of diagonal Gaussians:
      0.5 * sum_d [ (m_q-m_p)^2/s_p^2 + s_q^2/s_p^2 - log(s_q^2/s_p^2) - 1 ].

    All args [..., D]; ``noise``: eps itself (post_mean's shape when per
    frame, else [D]).  Returns (z [..., D], kl [...]).
    """
    std = torch.clamp(post_std, min=1e-20)
    pstd = torch.clamp(prior_std, min=1e-20)
    if test_mode:
        z = post_mean
    else:
        _need(noise, generator, "sample_vec_and_kl")
        eps = noise
        if eps is None:
            shape = post_mean.shape if rand_per_frame else post_mean.shape[-1:]
            eps = torch.randn(shape, generator=generator,
                              device=post_mean.device)
        z = post_mean + std * eps.expand(post_mean.shape)
    rate2 = torch.square(std / pstd)
    diff2 = torch.square((post_mean - prior_mean) / pstd)
    kl = 0.5 * torch.sum(diff2 + rate2 - torch.log(rate2 + 1e-20) - 1.0,
                         dim=-1)
    return z, kl
