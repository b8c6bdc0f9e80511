"""Bayesian / Gaussian-process TDNN-F variants (port of
``tdnnf_nas_tpu.models.bayes``): the reference's fork-extra component
family as variational models.

- `BayesAffineComponent` (`nnet-simple-component.h:2338-2512`): an affine
  whose weight is variational, W = mean + std * eps with eps ~ N(0,1)
  (reparameterization), std = exp(rho) with `use-exp-std`, noise shared
  across the output dim with `share-std-output-sampling`; test mode uses
  the mean; a KL to an isotropic Gaussian prior joins the objective with
  weight `KL-scale`.  The `.affine` factor of `bayestdnnf-layer`.
- `GPActivationComponent` (`nnet-simple-component.h:2514-2690`, impl
  `.cc:7011-7131`): a learned per-dim activation, a convex mixture of
  {sigmoid, relu, tanh} whose mixture logits are variational, normalized
  by a softmax over the basis axis, floored at 1e-20.  The `.gpact` of
  `gptdnnf-layer`.
- `KLGaussianComponent`: the KL in closed form (``gaussian_kl``).

The layer is the plain TDNN-F layer with a variational second factor, so
the forward samples the effective weights and delegates to
``models/tdnnf.apply_model``; the GP activations ride its
``layer_activations`` hook.  The eps draws come from a ``torch.Generator``
or are passed in (``eps``), which is how the parity tests feed in the JAX
package's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.models import tdnnf as tdnnf_mod
from tdnnf_nas_torch.models.tdnnf import TdnnfModelConfig

# exp(rho) ceiling: the reference caps the pre-exp std-param at 46.05
# (`nnet-simple-component.cc:7064`) only to avoid inf; a saner cap here
RHO_MAX = 10.0
COEF_FLOOR = 1e-20  # `.cc:7074`


@dataclasses.dataclass(frozen=True)
class BayesTdnnfModelConfig(Config):
    """`bayestdnnf-layer` (gp_activation=False) / `gptdnnf-layer` (True)
    networks; defaults mirror the xconfig defaults
    (`composite_layers.py:857-873`, `:1070-1086`)."""

    base: TdnnfModelConfig = dataclasses.field(
        default_factory=TdnnfModelConfig)
    kl_scale: float = 1e-4        # KL-scale
    prior_std: float = 1.0        # weight prior N(0, prior_std^2)
    rho_init: float = -5.0        # initial std-param (std = exp(rho) ~ 0.007)
    use_exp_std: bool = True      # use-exp-std
    share_std_output_sampling: bool = True  # share-std-output-sampling
    gp_activation: bool = False   # gptdnnf-layer when True
    gpact_kl_scale: float = 1e-4  # gpact-KL-scale
    gpact_prior_std: float = 1e-3  # prior-std of the GP mixture logits


def variational_sample(mu, rho, generator: Optional[torch.Generator] = None,
                       *, use_exp_std: bool = True,
                       share_last_axis: bool = False, test_mode: bool = False,
                       eps: Optional[torch.Tensor] = None):
    """Reparameterized draw W = mu + std(rho) * eps, eps from ``generator``
    or given; ``mu`` in test mode.  share_last_axis: one eps broadcast over
    the last (output) axis, the `share-std-output-sampling` behavior
    (`nnet-simple-component.cc:7025-7038`), so eps is [..., 1]."""
    if test_mode:
        return mu
    std = torch.exp(torch.clamp(rho, max=RHO_MAX)) if use_exp_std else rho
    if eps is None:
        if generator is None:
            raise ValueError("a training-mode Bayes draw needs a generator "
                             "or its eps")
        shape = mu.shape[:-1] + (1,) if share_last_axis else mu.shape
        eps = torch.randn(shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
    return mu + std * eps


def gaussian_kl(mu, rho, prior_std: float, *, prior_mean: float = 0.0,
                use_exp_std: bool = True):
    """Analytic KL( N(mu, std^2) || N(prior_mean, prior_std^2) ), summed:
    the closed form of the graph-side `KLGaussianComponent`
    (`nnet-simple-component.h:2230-2290`)."""
    if use_exp_std:
        rho = torch.clamp(rho, max=RHO_MAX)
        log_std = rho
        var = torch.exp(2.0 * rho)
    else:
        std = torch.abs(rho) + 1e-12
        log_std = torch.log(std)
        var = std * std
    log_prior = math.log(prior_std)
    return torch.sum((log_prior - log_std)
                     + (var + torch.square(mu - prior_mean))
                     / (2.0 * prior_std ** 2)
                     - 0.5)


def gp_activation_coefs(logits):
    """Basis mixture coefficients from (sampled) logits [3, D]: softmax over
    the basis axis per dim, floored (`nnet-simple-component.cc:7071-7075`)."""
    return torch.clamp(torch.softmax(logits, dim=0), min=COEF_FLOOR)


def gp_activation(x, coefs):
    """out = c_sig*sigmoid(x) + c_relu*relu(x) + c_tanh*tanh(x)
    (`nnet-simple-component.cc:7077-7114`).  coefs: [3, D], x: [..., D]."""
    return (coefs[0] * torch.sigmoid(x) + coefs[1] * torch.relu(x)
            + coefs[2] * torch.tanh(x))


def init_bayes_model(cfg: BayesTdnnfModelConfig,
                     generator: torch.Generator, device=DEFAULT_DEVICE):
    """(params, bn_state): tdnnf params with each tdnnf affine factor
    replaced by a variational {mu, rho} pair (+ per-layer gpact logits when
    gp_activation), on ``device``."""
    device = resolve_device(device)
    params, bn_state = tdnnf_mod.init_model(cfg.base, generator, device)
    for i in range(cfg.base.num_tdnnf):
        name = f"tdnnf{i + 2}"
        layer = dict(params[name])
        mu = layer.pop("affine")
        layer["affine_mu"] = mu
        layer["affine_rho"] = torch.full_like(mu, cfg.rho_init)
        if cfg.gp_activation:
            # mean logits 0 => uniform 1/3 mixture at init
            shape = (3, cfg.base.hidden_dim)
            layer["gpact_mu"] = torch.zeros(shape, device=device)
            layer["gpact_rho"] = torch.full(shape, cfg.rho_init,
                                            device=device)
        params[name] = layer
    return params, bn_state


def apply_bayes_model(
    cfg: BayesTdnnfModelConfig,
    params,
    bn_state,
    feats: torch.Tensor,
    ivectors: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    dropout_p: Optional[float] = None,
    eps: Optional[Sequence[Optional[torch.Tensor]]] = None,
):
    """Forward pass.  Samples the variational weights (train mode; test
    mode uses the mean weights, the `test-flag`/`test-mode` behavior), then
    delegates to the plain TDNN-F forward.

    ``generator`` draws the eps of every variational factor (tdnnf layer
    i's affine, then its gpact logits), then the dropout masks; ``eps``:
    the 2 * num_tdnnf draws themselves, indexed [2*i] (affine) and
    [2*i + 1] (gpact), as the reference splits its key.

    Returns (chain_logits, xent_logits, new_bn_state, kl) where kl is the
    total weighted KL regularizer (add it to the loss; it includes kl_scale
    / gpact_kl_scale).
    """
    test_mode = not train
    if not test_mode and generator is None and eps is None:
        raise ValueError("training-mode Bayes forward needs a generator")
    eff = dict(params)
    activations = {} if cfg.gp_activation else None
    kl = torch.zeros((), device=feats.device)
    draw = lambda j: None if eps is None else eps[j]
    for i in range(cfg.base.num_tdnnf):
        name = f"tdnnf{i + 2}"
        layer = dict(params[name])
        mu, rho = layer.pop("affine_mu"), layer.pop("affine_rho")
        layer["affine"] = variational_sample(
            mu, rho, generator, use_exp_std=cfg.use_exp_std,
            share_last_axis=cfg.share_std_output_sampling,
            test_mode=test_mode, eps=draw(2 * i))
        kl = kl + cfg.kl_scale * gaussian_kl(mu, rho, cfg.prior_std,
                                             use_exp_std=cfg.use_exp_std)
        if cfg.gp_activation:
            g_mu, g_rho = layer.pop("gpact_mu"), layer.pop("gpact_rho")
            logits = variational_sample(
                g_mu, g_rho, generator, use_exp_std=cfg.use_exp_std,
                share_last_axis=cfg.share_std_output_sampling,
                test_mode=test_mode, eps=draw(2 * i + 1))
            coefs = gp_activation_coefs(logits)
            activations[name] = lambda x, c=coefs: gp_activation(x, c)
            kl = kl + cfg.gpact_kl_scale * gaussian_kl(
                g_mu, g_rho, cfg.gpact_prior_std,
                use_exp_std=cfg.use_exp_std)
        eff[name] = layer
    chain, xent, new_bn = tdnnf_mod.apply_model(
        cfg.base, eff, bn_state, feats, ivectors, train=train,
        generator=generator, dropout_p=dropout_p,
        layer_activations=activations)
    return chain, xent, new_bn, kl


def semiorth_param_paths(cfg: BayesTdnnfModelConfig):
    """Same constraint set as the plain model: the deterministic `linear`
    factors and prefinal linears (the Bayes affine is NOT constrained)."""
    return tdnnf_mod.semiorth_param_paths(cfg.base)
