"""Port's DARTS supernet modules vs the JAX package (CPU).

The small supernet of tests/test_scan_supernet.py (3 layers of width 16,
K = 2-3 candidates, bottleneck groups (2, 2)) on seeded numpy inputs.
JAX's random draws (uniform path indices, Gumbel uniforms, dropout masks)
are derived from its own keys, the way ``apply_supernet`` splits them on
the scanned and on the unrolled stack, and injected into the port through
its one noise seam, ``models.nas.draw_noise``.  Also the two bf16 repairs
of models/tdnnf.py (bypass scale, dropout scale), bit for bit.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.models import nas as jnas
from tdnnf_nas_tpu.models import tdnnf as jtdnnf
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.models import nas as tnas
from tdnnf_nas_torch.models import tdnnf as ttdnnf

torch.set_num_threads(1)

_BASE = dict(feat_dim=8, ivector_dim=0, hidden_dim=16, bottleneck_dim=4,
             time_strides=(1, 1, 1), num_pdfs=6, prefinal_big=16,
             prefinal_small=8, compute_dtype="float32")


def darts_cfgs(base=None, **kw):
    """(JAX DartsModelConfig, port DartsModelConfig) with the same fields."""
    base = dict(_BASE, **(base or {}))
    jc = jnas.DartsModelConfig(base=jtdnnf.TdnnfModelConfig(**base), **kw)
    tc = tnas.DartsModelConfig(base=ttdnnf.TdnnfModelConfig(**base), **kw)
    return jc, tc


def to_torch(tree):
    return convert.tree_to_torch(jax.tree.map(np.asarray, tree), device="cpu")


def seeded_supernet(jcfg, seed):
    """(params, alphas, bn_state) of JAX ``init_supernet``'s keys and
    shapes, drawn from ``RandomState(seed)`` (no JAX compiles): weights
    N(0, 1/16), output layers x0.1 so that no gradient is degenerate,
    alphas N(0, 1), BN means N(0, 0.01) and vars 1 + U(0, 0.1)."""
    shapes = jax.eval_shape(lambda: jnas.init_supernet(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("var"):
            return jnp.asarray(1.0 + 0.1 * rng.rand(*s.shape), jnp.float32)
        scale = (0.1 if "output" in name or name.endswith("mean")
                 else 1.0 if "offsets" in name or "bottleneck" in name
                 else 0.25)
        return jnp.asarray(scale * rng.randn(*s.shape), jnp.float32)

    return tuple(jax.tree_util.tree_map_with_path(draw, t) for t in shapes)


def jax_draws(cfg, mode, key, batch, dropout_key=None, dropout_p=0.0):
    """The draws JAX's ``apply_supernet(cfg, mode=mode, key=key,
    dropout_key=dropout_key, train=True)`` makes, as [(kind, array)] in
    the port's order: tdnn1's dropout mask, then per layer the linear,
    affine and bottleneck samples and the layer's dropout mask."""
    n_layers = cfg.num_layers
    per_seq = (batch,) if cfg.sample_per_sequence else ()
    keep = 1.0 - jnp.asarray(dropout_p, jnp.float32)
    hidden = cfg.base.hidden_dim
    scan = cfg.search_offsets and cfg.scan_layers
    flat = (iter(jax.random.split(key, 4 * n_layers + 2))
            if key is not None else None)
    dk = (iter(jax.random.split(dropout_key, 32))
          if dropout_key is not None else None)

    def sample(k, n):
        if mode == jnas.SearchMode.UNIFORM:
            return "randint", jax.random.randint(k, per_seq, 0, n)
        return "uniform", jax.random.uniform(k, per_seq + (n,), minval=1e-8,
                                             maxval=1.0 - 1e-8)

    def mask(k):
        return "bernoulli", jax.random.bernoulli(k, keep, (batch, 1, hidden))

    sampling = mode in (jnas.SearchMode.UNIFORM, jnas.SearchMode.GUMBEL)
    out = []
    if dropout_p > 0.0 and dk is not None:
        out.append(mask(next(dk)))
    for i in range(n_layers):
        if scan:
            lk = jax.random.split(jax.random.fold_in(key, i), 4)
            ks = {"lin": lk[0], "aff": lk[1], "bn": lk[2]}
            kd = lk[3]
        else:
            ks = {}
            if cfg.search_offsets:
                ks["lin"], ks["aff"] = next(flat), next(flat)
            if cfg.search_bottleneck:
                ks["bn"] = next(flat)
            kd = next(dk) if dk is not None else None
        if sampling and cfg.search_offsets:
            out.append(sample(ks["lin"], cfg.num_candidates))
            out.append(sample(ks["aff"], cfg.num_candidates))
        if sampling and cfg.search_bottleneck:
            out.append(sample(ks["bn"], len(cfg.bottleneck_groups)))
        if dropout_p > 0.0 and kd is not None:
            out.append(mask(kd))
    return [(kind, np.asarray(a)) for kind, a in out]


@contextlib.contextmanager
def injected(draws):
    """Route the port's draws to ``draws``, in order, checking each kind
    and shape; all must be consumed."""
    queue = list(draws)

    def fake(kind, shape, generator, device, arg):
        assert queue, f"unexpected {kind} draw"
        want, a = queue.pop(0)
        assert kind == want and tuple(shape) == a.shape, (kind, shape, want,
                                                          a.shape)
        t = torch.tensor(a, device=device)
        return t.float() if kind == "bernoulli" else t

    with mock.patch.object(tnas, "draw_noise", fake):
        yield
    assert not queue, f"{len(queue)} draws left"


@pytest.mark.parametrize("kind", ["randint", "uniform", "bernoulli"])
def test_draw_noise_distributions(kind):
    """The port's own draws (used whenever no test replaces the seam):
    range, shape, dtype and mean of 20,000 samples from a seeded
    generator, and a generator is required."""
    gen = torch.Generator().manual_seed(0)
    arg = {"randint": 7, "uniform": None, "bernoulli": 0.8}[kind]
    x = tnas.draw_noise(kind, (100, 200), gen, "cpu", arg)
    assert tuple(x.shape) == (100, 200)
    if kind == "randint":
        assert x.dtype == torch.int64 and int(x.min()) == 0
        assert int(x.max()) == 6
        counts = torch.bincount(x.flatten(), minlength=7).float() / x.numel()
        assert float((counts - 1 / 7).abs().max()) < 0.01
    elif kind == "uniform":
        assert x.dtype == torch.float32
        assert float(x.min()) >= 1e-8 and float(x.max()) < 1.0
        assert abs(float(x.mean()) - 0.5) < 0.01
    else:
        assert set(torch.unique(x).tolist()) == {0.0, 1.0}
        assert abs(float(x.mean()) - 0.8) < 0.01
    with pytest.raises(ValueError):
        tnas.draw_noise(kind, (2,), None, "cpu", arg)


# ---------------------------------------------------------------- repairs

def _bf16_pair(seed, shape=(4, 50, 300)):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


def test_bypass_scale_matches_jax_bf16():
    """``_bypass`` scales by the bypass scale cast to the compute dtype,
    bf16(0.66) = 0.66015625, as the reference does: equal bit for bit."""
    jcur, tcur = _bf16_pair(0)
    jprev, tprev = _bf16_pair(1)
    ref = jcur + jnp.asarray(0.66, jcur.dtype) * jprev
    out = ttdnnf._bypass(tcur, tprev, 0.66)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_dropout_scale_matches_jax_bf16(p):
    """Dropout with the mask ``jax.random.bernoulli`` drew divides by
    max(1 - p, 1e-3) cast to bf16, as the reference does: equal bit for
    bit to ``tdnnf._dropout`` (at p = 0.1, 1/0.8984375, not 1/0.9)."""
    jx, tx = _bf16_pair(2)
    key = jax.random.PRNGKey(5)
    keep = 1.0 - jnp.asarray(p, jnp.float32)
    mask = np.asarray(jax.random.bernoulli(key, keep, (4, 1, 300)))
    ref = jtdnnf._dropout(jx, p, key, True)
    out = ttdnnf._apply_dropout(tx, torch.tensor(mask), p)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# ----------------------------------------------------- ops and coefficients

@pytest.mark.parametrize("per_seq", [False, True])
def test_spliced_linear_coef_matches_jax(per_seq):
    """``spliced_linear(coef=...)``: [K] shared or [B, K] per-sequence
    coefficients scale each offset's float32 product."""
    from tdnnf_nas_tpu.ops.tdnn import spliced_linear as jsl
    from tdnnf_nas_torch.ops.tdnn import spliced_linear as tsl

    rng = np.random.RandomState(3)
    x = rng.randn(3, 20, 6).astype(np.float32)
    w = rng.randn(3, 6, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    coef = rng.rand(*((3, 3) if per_seq else (3,))).astype(np.float32)
    offs = (-2, 0, 1)
    ref = jsl(jnp.asarray(x), jnp.asarray(w), offs, bias=jnp.asarray(b),
              coef=jnp.asarray(coef), compute_dtype=jnp.float32)
    out = tsl(torch.tensor(x), torch.tensor(w), offs, bias=torch.tensor(b),
              coef=torch.tensor(coef), compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


_MODES = ["uniform", "gumbel", "softmax", "free", "argmax_st", "fixed"]


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("share", [4, None])
def test_branch_coefs_match_jax(mode, batch, share):
    """Every mode, shared and per sequence, with and without a share
    branch, JAX's draws injected: the coefficients and the gradient of a
    weighted sum of them w.r.t. alpha."""
    alpha_np = np.random.RandomState(6).randn(5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tau = 0.7
    wts = np.random.RandomState(8).randn(*((batch, 5) if batch else (5,)))
    wts = wts.astype(np.float32)

    def jfn(a):
        c = jnas.branch_coefs(a, mode, tau, key, share, batch)
        return jnp.sum(c * wts), c

    (_, jc), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(alpha_np))
    draws = []
    shape = (batch,) if batch else ()
    if mode == "uniform":
        draws = [("randint", np.asarray(jax.random.randint(key, shape, 0, 5)))]
    elif mode == "gumbel":
        draws = [("uniform", np.asarray(jax.random.uniform(
            key, shape + (5,), minval=1e-8, maxval=1.0 - 1e-8)))]
    alpha = torch.tensor(alpha_np, requires_grad=True)
    with injected(draws):
        tc = tnas.branch_coefs(alpha, mode, tau, None, share, batch)
    assert tuple(tc.shape) == jc.shape
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc),
                               rtol=1e-6, atol=1e-7)
    if tc.requires_grad:
        tg, = torch.autograd.grad((tc * torch.tensor(wts)).sum(), alpha)
    else:
        tg = torch.zeros(5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def test_bottleneck_mask_and_expected_flops_match_jax():
    """The nested group mask (shared and per sequence) and the expected
    bottleneck width with its alpha gradient."""
    rng = np.random.RandomState(9)
    groups = (25, 25, 30, 20, 20, 40, 40, 40)
    for shape in ((8,), (3, 8)):
        c = rng.rand(*shape).astype(np.float32)
        ref = jnas._bottleneck_mask(jnp.asarray(c), groups)
        out = tnas._bottleneck_mask(torch.tensor(c), groups)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    jc, tc = darts_cfgs(search_offsets=False, search_bottleneck=True)
    a = rng.randn(3, 8).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda x: jnas.expected_flops(x, jc, 0.5))(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    tv = tnas.expected_flops(ta, tc, 0.5)
    tg, = torch.autograd.grad(tv, ta)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    assert tnas.BOTTLENECK_DIMS == jnas.BOTTLENECK_DIMS


_INIT_CASES = {
    "offsets": dict(search_offsets=True, max_stride=2),
    "both": dict(search_offsets=True, max_stride=2, search_bottleneck=True,
                 bottleneck_groups=(2, 2)),
    "fixed_bottleneck": dict(search_offsets=False,
                             fixed_strides=((1, 2), (0, 1), (2, 0)),
                             search_bottleneck=True, bottleneck_groups=(2, 2)),
}


@pytest.mark.parametrize("case", sorted(_INIT_CASES))
def test_init_supernet_keys_and_shapes_match_jax(case):
    jc, tc = darts_cfgs(**_INIT_CASES[case])
    ref = jax.eval_shape(lambda: jnas.init_supernet(jc, jax.random.PRNGKey(0)))
    out = tnas.init_supernet(tc, torch.Generator().manual_seed(0),
                             device="cpu")
    for j, t in zip(ref, out):
        assert (jax.tree.map(lambda x: tuple(x.shape), j)
                == jax.tree.map(lambda x: tuple(x.shape), t))
    tp, ta, tb = out
    assert torch.equal(tp["lda"]["w"], torch.eye(tc.base.lda_dim))
    assert all(float(a.abs().sum()) == 0.0 for a in ta.values())
    assert all(torch.equal(v["var"], torch.ones_like(v["var"]))
               for v in tb.values())
    assert tnas.supernet_context(tc) == jnas.supernet_context(jc)
    assert tc.supernet_bottleneck == jc.supernet_bottleneck
    assert tc.bottleneck_candidates == jc.bottleneck_candidates


# ------------------------------------------------------------ the forward

# name -> (config fields, base fields, mode, train, bn_frozen, dropout_p)
_OFFSETS = dict(search_offsets=True, max_stride=2)
_BF16 = dict(compute_dtype="bfloat16")
_FWD = {
    "offsets_softmax_train": (_OFFSETS, {}, "softmax", True, False, 0.0),
    "offsets_uniform_perseq_bnfrozen": (
        dict(_OFFSETS, sample_per_sequence=True), {}, "uniform", True, True,
        0.0),
    "offsets_gumbel_dropout": (_OFFSETS, {}, "gumbel", True, False, 0.2),
    "offsets_k2_argmax_bnfrozen": (dict(search_offsets=True, max_stride=1),
                                   {}, "argmax_st", True, True, 0.0),
    "both_gumbel_perseq": (dict(_INIT_CASES["both"],
                                sample_per_sequence=True), {}, "gumbel", True,
                           False, 0.0),
    "fixed_bottleneck_uniform": (_INIT_CASES["fixed_bottleneck"], {},
                                 "uniform", True, False, 0.0),
    "fixed_bottleneck_softmax_eval": (_INIT_CASES["fixed_bottleneck"], {},
                                      "softmax", False, False, 0.0),
    "offsets_softmax_bf16": (_OFFSETS, _BF16, "softmax", True, False, 0.0),
    "both_uniform_bf16": (_INIT_CASES["both"], _BF16, "uniform", True, False,
                          0.0),
}

# the scanned stack: offset supernets only (scan_layers applies to them),
# once per sampling mode, bf16 and the bottleneck combo
_SCAN = ("offsets_softmax_train", "offsets_uniform_perseq_bnfrozen",
         "offsets_gumbel_dropout", "both_gumbel_perseq",
         "offsets_softmax_bf16")
_FWD_RUNS = ([(name, False) for name in sorted(_FWD)]
             + [(name, True) for name in _SCAN])


def _loss_j(out):
    c, xe = out[0].astype(jnp.float32), out[1].astype(jnp.float32)
    return jnp.sum(jnp.square(c)) + 0.5 * jnp.sum(jnp.square(xe))


@pytest.mark.parametrize("name,scan", _FWD_RUNS)
def test_apply_supernet_matches_jax(name, scan):
    """Logits, BN stats and coefs against JAX's ``apply_supernet`` (its
    scanned and its unrolled stack), and in float32 the gradients w.r.t.
    params and alphas, at the reference's own bars
    (tests/test_scan_supernet.py: 2e-4/2e-5 forward, 2e-3/2e-4 gradients
    in float32, 3e-2 in bf16)."""
    kw, base, mode, train, frozen, p = _FWD[name]
    jc, tc = darts_cfgs(base=base, scan_layers=scan, **kw)
    params, alphas, bn = seeded_supernet(jc, 7)
    rng = np.random.RandomState(11)
    left, right = jnas.supernet_context(jc)
    x = rng.randn(2, left + right + 3 * 5 + 1, 8).astype(np.float32)
    key, dkey = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    tau = 0.8

    def jloss(pp, aa):
        out = jnas.apply_supernet(jc, pp, aa, bn, jnp.asarray(x), mode=mode,
                                  tau=tau, key=key, train=train,
                                  bn_frozen=frozen, dropout_key=dkey,
                                  dropout_p=p if p else None)
        return _loss_j(out), out

    # one compile gives the outputs and the gradients
    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True))(params, alphas)
    draws = jax_draws(jc, mode, key, 2, dkey if train else None, p)
    tparams, talphas, tbn = to_torch(params), to_torch(alphas), to_torch(bn)
    leaves = jax.tree.leaves(tparams) + jax.tree.leaves(talphas)
    for leaf in leaves:
        leaf.requires_grad_(True)
    with injected(draws):
        tout = tnas.apply_supernet(tc, tparams, talphas, tbn, torch.tensor(x),
                                   mode=mode, tau=tau,
                                   generator=torch.Generator(), train=train,
                                   bn_frozen=frozen,
                                   dropout_p=p if p else None)
    bf16 = base.get("compute_dtype") == "bfloat16"
    tol = dict(rtol=3e-2, atol=3e-2) if bf16 else dict(rtol=2e-4, atol=2e-5)
    for j, t in ((jout[0], tout[0]), (jout[1], tout[1])):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j, np.float32), **tol)
    for layer in jout[2]:
        for f in ("mean", "var"):
            np.testing.assert_allclose(tout[2][layer][f].numpy(),
                                       np.asarray(jout[2][layer][f]), **tol,
                                       err_msg=f"{layer}/{f}")
    # the scanned stack records no bottleneck coefs
    assert set(jout[3]) <= set(tout[3])
    for k in jout[3]:
        np.testing.assert_allclose(tout[3][k].detach().numpy(),
                                   np.asarray(jout[3][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if bf16:
        return
    loss = torch.sum(tout[0] ** 2) + 0.5 * torch.sum(tout[1] ** 2)
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    jleaves = jax.tree.leaves(jg[0]) + jax.tree.leaves(jg[1])
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        a = np.zeros(b.shape, np.float32) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3, atol=2e-4)
