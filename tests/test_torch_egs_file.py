"""The port's TEGS shards, native loader and a step on a loaded batch vs
the JAX package (float32, CPU); the loader's build failure; the
``right_context`` branch of ``prepare_data``.

The world of tests/test_egs_file.py, built through each package's own
host modules: 24 utterances of 5 phones, the bigram LM's dense den graph,
a 2-layer model of width 24, chunk width 12.
"""

import dataclasses
import os
import stat

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.data import native
from tdnnf_nas_torch.data.egs_file import NativeEgsLoader, write_egs_file
from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
from tdnnf_nas_torch.train.optimizer import tree_paths

torch.set_num_threads(1)


def _world(pkg, directory):
    """(chunks, shard path, model_cfg, den) through one package."""
    if pkg == "jax":
        from tdnnf_nas_tpu import data, graphs, models
        from tdnnf_nas_tpu.data.egs_file import write_egs_file as write
    else:
        from tdnnf_nas_torch import data, graphs, models
        write = write_egs_file
    corpus_cfg = data.SyntheticCorpusConfig(num_utts=24, num_phones=5,
                                            feat_dim=10)
    utts, phone_seqs, tree, topo = data.make_synthetic_corpus(corpus_cfg)
    lm = graphs.estimate_phone_lm(phone_seqs, 5)
    den = graphs.build_denominator_graph(lm, topo, tree)
    model_cfg = models.TdnnfModelConfig(
        feat_dim=10, ivector_dim=0, hidden_dim=24, bottleneck_dim=8,
        time_strides=(1, 2), num_pdfs=tree.num_pdfs, prefinal_big=24,
        prefinal_small=12, compute_dtype="float32")
    left, right = models.model_context(model_cfg)
    egs_cfg = data.EgsConfig(chunk_width=12, left_context=left,
                             right_context=right, max_phones_per_chunk=10)
    chunks = data.make_egs(utts, lm, topo, tree, egs_cfg,
                           den_init_fn=graphs.den_init_lookup(den, 5))
    path = os.path.join(directory, f"{pkg}.tegs")
    write(chunks, path)
    return chunks, path, model_cfg, den


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("egs"))
    return {pkg: _world(pkg, d) for pkg in ("jax", "torch")}


def _loader_batches(loader_cls, path, seed, n):
    loader = loader_cls(path, batch_size=4, seed=seed)
    try:
        it = iter(loader)
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def test_shards_byte_identical(world):
    """Same chunks (each package's own host code, same seed) -> the port's
    shard equals the reference's byte for byte."""
    jchunks, jpath = world["jax"][:2]
    tchunks, tpath = world["torch"][:2]
    assert len(tchunks) == len(jchunks) > 8
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        ja, tb = a.read(), b.read()
    assert len(ja) > 1000 and ja == tb


def test_loaders_yield_identical_batches(world):
    """The port's loader and the reference's on one shard with one seed:
    3 identical batches, uint8 mask, dummy trans, compact next_w."""
    from tdnnf_nas_tpu.data.egs_file import NativeEgsLoader as JLoader

    path = world["torch"][1]
    jb = _loader_batches(JLoader, path, 1, 3)
    tb = _loader_batches(NativeEgsLoader, path, 1, 3)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a["feats"], b["feats"])
        assert a["feats"].dtype == np.float32
        for f in ("trans", "state_pdf", "init", "final", "mask", "next_w"):
            x, y = getattr(a["sup"], f), getattr(b["sup"], f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert a["sup"].mask.dtype == np.uint8
        assert a["sup"].trans.shape == (4, 1, 1)
        assert a["sup"].self_loop_prob == b["sup"].self_loop_prob
    # the batches are chunks of the shard, in shuffled order
    orig = {c.feats.tobytes(): c for c in world["torch"][0]}
    for b in tb:
        for i in range(4):
            c = orig[np.ascontiguousarray(b["feats"][i]).tobytes()]
            np.testing.assert_array_equal(b["sup"].mask[i] > 0,
                                          c.sup.mask > 0)
            np.testing.assert_array_equal(b["sup"].next_w[i], c.sup.next_w)


def test_step_on_loader_batch_matches_jax(world):
    """One port step on a loader batch (uint8 mask) against the JAX step on
    the same batch: objf_mmi within 5e-4 (__graft_entry__.py:119), the
    other metrics within 1e-4; and the port's step on the same batch with
    a float32 0/1 mask is the same step bit for bit (the numerator reads
    ``mask > 0``)."""
    from tdnnf_nas_tpu.data.egs_file import NativeEgsLoader as JLoader
    from tdnnf_nas_tpu.ops.fwdbwd import DenGraphArrays as JDen
    from tdnnf_nas_tpu.train import TrainerConfig as JTC
    from tdnnf_nas_tpu.train import init_train_state as jinit
    from tdnnf_nas_tpu.train import make_train_step as jmake
    from tdnnf_nas_torch.train import TrainerConfig, make_train_step

    _, path, jcfg, jden = world["jax"]
    _, _, tcfg, tden = world["torch"]
    jbatch, = _loader_batches(JLoader, path, 2, 1)
    tbatch, = _loader_batches(NativeEgsLoader, path, 2, 1)
    jst = jinit(jcfg, JTC(), jax.random.PRNGKey(0))
    _, jm = jmake(jcfg, JTC(), JDen.from_graph(jden), donate=False)(
        jst, jax.tree.map(jnp.asarray, jbatch), jax.random.PRNGKey(1))

    def port_state():
        return convert.train_state_from_numpy(
            *(jax.tree.map(np.asarray, t) for t in (
                jst.params, jst.bn_state, jst.opt_state)), int(jst.step),
            device="cpu")

    step = make_train_step(tcfg, TrainerConfig(),
                           DenGraphArrays.from_graph(tden, "cpu"))
    u8 = convert.batch_to_torch(tbatch, device="cpu")
    assert u8["sup"].mask.dtype == torch.uint8
    new_u8, tm = step(port_state(), u8)
    assert abs(float(tm["objf_mmi"]) - float(jm["objf_mmi"])) < 5e-4
    for k in ("loss", "logz_num", "logz_den", "objf_xent", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    f32 = dict(u8, sup=dataclasses.replace(u8["sup"],
                                           mask=u8["sup"].mask.float()))
    new_f32, tm32 = step(port_state(), f32)
    for k in tm:
        assert torch.equal(torch.as_tensor(tm[k]),
                           torch.as_tensor(tm32[k])), k
    for (p, x), (_, y) in zip(tree_paths(new_u8.params),
                              tree_paths(new_f32.params)):
        assert torch.equal(x, y), p


@pytest.mark.parametrize("compiler", ["fails", "missing"])
def test_loader_build_failure_raises(world, tmp_path, monkeypatch, compiler):
    """A loader whose library cannot be built raises with the compiler's
    output; nothing falls back, and no library is left behind."""
    if compiler == "fails":
        cxx = tmp_path / "cxx"
        cxx.write_text("#!/bin/sh\necho 'egs_loader.cc:1: fake compiler "
                       "error' >&2\nexit 3\n")
        cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
        match = "fake compiler error"
    else:
        cxx = tmp_path / "no-such-compiler"
        match = "cannot run"
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=match):
            NativeEgsLoader(world["torch"][1], batch_size=4)
        with pytest.raises(RuntimeError, match=match):
            native.build()
    finally:
        native.get_lib.cache_clear()
    assert not list(build_dir.glob("*.so"))


def test_loader_library_is_keyed_and_standalone():
    """The port builds egs_loader.cc alone into its own build directory,
    under a name keyed on the source and flags, and binds the three entry
    points; it never loads the JAX package's native/libegs.so."""
    lib = native.get_lib()
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("egs_loader_") and so.suffix == ".so"
    assert lib._name == str(so)
    for name in ("egs_loader_create", "egs_loader_next",
                 "egs_loader_destroy"):
        assert getattr(lib, name).argtypes is not None, name


class _PlusMinusOneTree:
    """A +-1 context tree as far as ``prepare_data`` looks: no
    ``forward_pdf``, which the dense den builder would call."""

    context_width = 2
    right_context = 1
    num_pdfs = 10


def test_prepare_data_right_context_takes_composed_branch(monkeypatch):
    """A bigram LM with a +-1 tree takes the composed den branch, as in the
    reference (its ``compile_denominator_fsa`` is reached); the port's
    raises NotImplementedError there until the +-1 composition is ported,
    where the dense branch would fail in ``forward_pdf``."""
    from tdnnf_nas_tpu.recipes import chain_recipes as jrec
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.recipes import chain_recipes as trec

    utts, phone_seqs, _, topo = make_synthetic_corpus(
        SyntheticCorpusConfig(num_utts=8, num_phones=5, feat_dim=10))

    class Composed(Exception):
        pass

    def reached(*args, **kw):
        raise Composed

    monkeypatch.setattr(jrec, "compile_denominator_fsa", reached)
    with pytest.raises(Composed):
        jrec.prepare_data(utts, phone_seqs, _PlusMinusOneTree(), topo, 5,
                          phone_lm_order=2)
    with pytest.raises(NotImplementedError, match="committed"):
        trec.prepare_data(utts, phone_seqs, _PlusMinusOneTree(), topo, 5,
                          phone_lm_order=2)
