"""The dense numerator branch of the port's ``chain_objective`` (a
supervision without ``next_w``: ``forward_score`` over the per-sequence
[S, S] ``trans`` with the tolerance mask) against the JAX package's, and
the native supervision builder (``native/egs_builder.cc``, built by
``data/native.py``) against the port's Python builder, as
tests/test_native.py:26-88 holds the reference's, with the unaligned
mode and the native edit distance; then the dense numerator over the
builder's graphs against the linear numerator over the same graphs."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.graphs.supervision import \
    ChunkSupervision as JChunkSupervision
from tdnnf_nas_tpu.ops import fwdbwd as jfwd
from tdnnf_nas_tpu.train.objective import ChainObjectiveConfig as JCfg
from tdnnf_nas_tpu.train.objective import chain_objective as jobjective
from tdnnf_nas_torch import graphs as tgraphs
from tdnnf_nas_torch.data import native
from tdnnf_nas_torch.decode.scoring import edit_distance
from tdnnf_nas_torch.graphs.supervision import (ChunkSupervision,
                                                make_chunk_supervision)
from tdnnf_nas_torch.ops import fwdbwd as tfwd
from tdnnf_nas_torch.train.objective import (ChainObjectiveConfig,
                                             chain_objective)

torch.set_num_threads(1)

# tests/test_native.py's cases: (phones, begins, ends) at T = 14, S = 12
_CASES = [([1, 3, 0, 2], [0, 3, 7, 11], [2, 6, 10, 13]),
          ([5, 4], [0, 8], [7, 13]),
          ([2, 2, 1], [1, 5, 9], [4, 8, 13])]
_T, _S, _TOL = 14, 12, 2


def _ci_world(num_phones=6, seed=0):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(0, num_phones, size=8).tolist() for _ in range(30)]
    lm = tgraphs.estimate_phone_lm(seqs, num_phones)
    topo = tgraphs.ChainTopology(num_phones)
    tree = tgraphs.ContextIndependentTree(num_phones)
    den = tgraphs.build_denominator_graph(lm, topo, tree)
    return lm, topo, tree, den


def _stack_dense(sups):
    """Stacked [B, ...] supervision that keeps the dense trans and drops
    next_w, so the objective takes the dense branch."""
    return {f: np.stack([getattr(s, f) for s in sups])
            for f in ("trans", "state_pdf", "init", "final", "mask")}


def _dense_sup(num_pdfs, seed=0):
    """(port ChunkSupervision of CPU tensors without next_w, [B, T, P]
    outputs) for _CASES, pdfs below ``num_pdfs``."""
    lm, topo, tree, den = _ci_world()
    init_fn = tgraphs.den_init_lookup(den, 6)
    sups = [make_chunk_supervision(ph, bg, en, lm, topo, tree, _T, _S,
                                   tol=_TOL, den_init_fn=init_fn)
            for ph, bg, en in _CASES]
    arrays = _stack_dense(sups)
    arrays["state_pdf"] = arrays["state_pdf"] % num_pdfs
    sup = ChunkSupervision(**{k: torch.from_numpy(v)
                              for k, v in arrays.items()},
                           next_w=None, self_loop_prob=topo.self_loop_prob)
    out = (np.random.RandomState(seed).randn(len(_CASES), _T, num_pdfs)
           * 2).astype(np.float32)
    return sup, out


def test_dense_numerator_branch_matches_jax():
    """Every metric (rtol 1e-5) and d loss / d chain_out (atol 1e-5) of
    chain_objective on a dense numerator and a dense den."""
    lm, topo, tree, den = _ci_world()
    sup, out = _dense_sup(tree.num_pdfs)
    rng = np.random.RandomState(1)
    xent = rng.randn(*out.shape).astype(np.float32)
    jsup = JChunkSupervision(**{k: jnp.asarray(getattr(sup, k).numpy())
                                for k in ("trans", "state_pdf", "init",
                                          "final", "mask")},
                             next_w=None,
                             self_loop_prob=sup.self_loop_prob)
    jden = jfwd.DenGraphArrays.from_graph(den)

    def jloss(o):
        return jobjective(o, jnp.asarray(xent), jden, jsup, JCfg())

    (_, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(out))
    o = torch.from_numpy(out).requires_grad_(True)
    loss, tm = chain_objective(o, torch.from_numpy(xent),
                               tfwd.DenGraphArrays.from_graph(den, "cpu"),
                               sup, ChainObjectiveConfig())
    tgrad, = torch.autograd.grad(loss, o)
    for k in ("objf_mmi", "logz_num", "logz_den", "objf_xent", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-5)


def test_native_supervision_matches_python():
    """Each chunk's trans, pdfs, init, final and mask equal the Python
    builder's bit for bit."""
    lm, topo, tree, den = _ci_world()
    fwd, slf = native.tree_tables(tree, 6)
    de, dl = native.den_init_tables(den, 6)
    out = native.build_supervision_batch_native(
        [c[0] for c in _CASES], [c[1] for c in _CASES],
        [c[2] for c in _CASES], lm.probs, fwd, slf, de, dl,
        topo.self_loop_prob, _TOL, _T, _S)
    init_fn = tgraphs.den_init_lookup(den, 6)
    for i, (ph, bg, en) in enumerate(_CASES):
        ref = make_chunk_supervision(ph, bg, en, lm, topo, tree, _T, _S,
                                     tol=_TOL, den_init_fn=init_fn)
        for f in ("trans", "state_pdf", "init", "final", "mask"):
            np.testing.assert_array_equal(out[f][i], getattr(ref, f),
                                          err_msg=f)


def test_native_unaligned_mode():
    num_phones = 4
    rng = np.random.RandomState(1)
    seqs = [rng.randint(0, num_phones, size=6).tolist() for _ in range(20)]
    lm = tgraphs.estimate_phone_lm(seqs, num_phones)
    topo = tgraphs.ChainTopology(num_phones)
    tree = tgraphs.ContextIndependentTree(num_phones)
    fwd, slf = native.tree_tables(tree, num_phones)
    out = native.build_supervision_batch_native(
        [[0, 1, 2]], None, None, lm.probs, fwd, slf, None, None,
        topo.self_loop_prob, 2, 10, 8)
    ref = make_chunk_supervision([0, 1, 2], None, None, lm, topo, tree, 10,
                                 8)
    for f in ("trans", "state_pdf", "init", "final", "mask"):
        np.testing.assert_array_equal(out[f][0], getattr(ref, f), err_msg=f)


def test_native_edit_distance():
    """(sub, ins, del, hits) of each pair: the total cost equals the
    Python edit distance's, and hits + sub + del is the reference's
    length."""
    rng = np.random.RandomState(2)
    refs = [rng.randint(0, 5, size=rng.randint(1, 12)).tolist()
            for _ in range(25)]
    hyps = [rng.randint(0, 5, size=rng.randint(1, 12)).tolist()
            for _ in range(25)]
    out = native.edit_distance_batch_native(refs, hyps)
    for i, (r, h) in enumerate(zip(refs, hyps)):
        c = edit_distance(r, h)
        assert out[i, 0] + out[i, 1] + out[i, 2] == c["sub"] + c["ins"] + \
            c["del"], (i, out[i], c)
        assert out[i, 3] + out[i, 0] + out[i, 2] == len(r)


def test_native_builder_mismatched_spans_raise():
    lm, topo, tree, _ = _ci_world()
    fwd, slf = native.tree_tables(tree, 6)
    with pytest.raises(ValueError, match="lengths"):
        native.build_supervision_batch_native(
            [[1, 2]], [[0]], [[3]], lm.probs, fwd, slf, None, None,
            topo.self_loop_prob, 2, 10, 8)


def test_dense_numerator_equals_linear_on_native_graphs():
    """The native builder's dense graphs through the dense numerator and
    their banded form (next_w read off the trans superdiagonal) through
    the linear numerator: logZ within rtol 1e-5."""
    lm, topo, tree, den = _ci_world()
    fwd, slf = native.tree_tables(tree, 6)
    de, dl = native.den_init_tables(den, 6)
    out = native.build_supervision_batch_native(
        [c[0] for c in _CASES], [c[1] for c in _CASES],
        [c[2] for c in _CASES], lm.probs, fwd, slf, de, dl,
        topo.self_loop_prob, _TOL, _T, _S)
    trans = torch.from_numpy(out["trans"])
    next_w = trans[:, torch.arange(0, _S, 2), torch.arange(2, _S + 2, 2) % _S]
    next_w[:, -1] = 0.0
    obs = torch.from_numpy((np.random.RandomState(3).randn(
        len(_CASES), _T, tree.num_pdfs) * 2).astype(np.float32))
    args = [torch.from_numpy(out[k]) for k in ("state_pdf", "init", "final")]
    mask = torch.from_numpy(out["mask"])
    z_dense = tfwd.forward_score(obs, trans, *args, mask=mask)
    z_lin = tfwd.forward_score_linear(obs, next_w, *args, mask,
                                      topo.self_loop_prob)
    np.testing.assert_allclose(z_dense.numpy(), z_lin.numpy(), rtol=1e-5)
