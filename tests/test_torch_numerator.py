"""Port's linear-chain numerator ``forward_score_linear`` vs the JAX package.

logZ and the occupancy posteriors gamma = d logZ / d obs, on the
supervision setup of tests/test_objective.py, including its badly-matched
case (+-40-nat outputs anti-correlated with the supervision).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.ops.fwdbwd import forward_score_linear as jlinear
from tdnnf_nas_torch.ops.fwdbwd import forward_score_linear as tlinear
from tests.test_objective import _setup

torch.set_num_threads(1)


def _port(obs, sup):
    o = torch.tensor(np.asarray(obs), requires_grad=True)
    z = tlinear(o, torch.tensor(sup.next_w), torch.tensor(sup.state_pdf),
                torch.tensor(sup.init), torch.tensor(sup.final),
                torch.tensor(sup.mask), sup.self_loop_prob)
    gamma, = torch.autograd.grad(z.sum(), o)
    return z.detach().numpy(), gamma.numpy()


def _jax(obs, sup):
    args = (jnp.asarray(sup.next_w), jnp.asarray(sup.state_pdf),
            jnp.asarray(sup.init), jnp.asarray(sup.final),
            jnp.asarray(sup.mask))

    def tot(o):
        z = jlinear(o, *args, sup.self_loop_prob)
        return jnp.sum(z), z

    (_, z), gamma = jax.value_and_grad(tot, has_aux=True)(jnp.asarray(obs))
    return np.asarray(z), np.asarray(gamma)


@pytest.mark.parametrize("case,gamma_atol", [("plain", 1e-5),
                                             ("badly_matched", 1e-4)])
def test_linear_numerator_matches_jax(case, gamma_atol):
    """Same log-space recursion in both; float32 sums in another order
    bound the difference (logZ: rtol 1e-5).  Posteriors are
    exp(log-alpha + log-beta - logZ): in the plain case these sums are tens
    of nats (atol 1e-5); in the badly-matched case hundreds of nats, where
    one float32 ulp is ~3e-5 and the posteriors inherit that relative
    error (atol 1e-4)."""
    if case == "plain":
        _, sup, obs = _setup()
    else:
        _, sup, obs = _setup(seed=3, t=12)
        rng = np.random.RandomState(9)
        obs = rng.randn(*obs.shape).astype(np.float32) * 20.0
    z, gamma = _port(obs, sup)
    zj, gj = _jax(obs, sup)
    assert np.isfinite(z).all() and np.isfinite(gamma).all()
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gamma, gj, atol=gamma_atol)
    # posteriors of each frame sum to one
    np.testing.assert_allclose(gamma.sum(-1), 1.0, atol=1e-4)
