"""The port's host copies against the JAX package: Kaldi ark/scp I/O
(byte-identical files from both packages, each reading the other's),
``train/transforms`` (SVD factoring and bottleneck reduction) and
``graphs/wpd`` (word-position marks)."""

import struct

import numpy as np
import pytest
import jax
import torch

from tdnnf_nas_tpu.data import kaldi_io as jkio
from tdnnf_nas_tpu.graphs import wpd as jwpd
from tdnnf_nas_tpu.models import tdnnf as jtdnnf
from tdnnf_nas_tpu.train import transforms as jtr
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.data import kaldi_io as tkio
from tdnnf_nas_torch.graphs import wpd as twpd
from tdnnf_nas_torch.models import tdnnf as ttdnnf
from tdnnf_nas_torch.train import transforms as ttr

torch.set_num_threads(1)


def _mats(seed):
    rng = np.random.RandomState(seed)
    return [(f"utt{i}", (rng.randn(rng.randint(5, 30), 13) * 3 + i
                         ).astype(np.float32)) for i in range(4)]


def _write_both(tmp_path, name, **kw):
    """Write the same items with each package to the same ark/scp paths
    in turn; returns ({pkg: (ark bytes, scp bytes)}, ark, scp)."""
    ark, scp = str(tmp_path / f"{name}.ark"), str(tmp_path / f"{name}.scp")
    out = {}
    for pkg, mod in (("jax", jkio), ("torch", tkio)):
        mod.write_ark(ark, kw["items"], scp_path=scp,
                      **{k: v for k, v in kw.items() if k != "items"})
        with open(ark, "rb") as f, open(scp, "rb") as g:
            out[pkg] = (f.read(), g.read())
    return out, ark, scp


@pytest.mark.parametrize("compress", [False, True], ids=["FM", "CM"])
def test_matrix_arks_byte_identical(tmp_path, compress):
    """FM and CompressedMatrix (format 1) arks and their scps: the same
    bytes from both packages; each package reads them (ark and scp) to
    equal arrays, within one compression step of each column's range for
    CM."""
    items = _mats(0)
    out, ark, scp = _write_both(tmp_path, "m", items=items,
                                compress=compress)
    assert out["jax"] == out["torch"]
    for mod in (jkio, tkio):
        got = dict(mod.read_ark(ark))
        entries = mod.read_scp(scp)
        assert [e[0] for e in entries] == [k for k, _ in items]
        for key, mat in items:
            a = mod.load_scp_matrix([e for e in entries if e[0] == key][0])
            np.testing.assert_array_equal(a, got[key])
            if compress:
                col = mat.max(0) - mat.min(0)
                # uint8 codes over the 25-75% span: 1/128 of it per step
                assert (np.abs(a - mat) / col).max() < 1.0 / 64, key
            else:
                np.testing.assert_array_equal(a, mat)
    ja = dict(jkio.read_ark(ark))
    for key, a in tkio.read_ark(ark):
        np.testing.assert_array_equal(a, ja[key])


def test_int_vector_arks_byte_identical(tmp_path):
    """Alignment arks (int32 vectors, an empty one too): the same bytes
    from both packages, each read by both."""
    ali = [("a", np.asarray([1, 5, 5, 5, 2, 2], np.int32)),
           ("b", np.asarray([0, 3], np.int32)), ("c", np.zeros(0, np.int32))]
    arks = {}
    for pkg, mod in (("jax", jkio), ("torch", tkio)):
        path = str(tmp_path / "ali.ark")
        mod.write_ark(path, ali, writer=mod.write_int_vector)
        with open(path, "rb") as f:
            arks[pkg] = f.read()
        for other in (jkio, tkio):
            got = dict(other.read_ark(path, reader=other.read_int_vector))
            for k, v in ali:
                np.testing.assert_array_equal(got[k], v)
    assert arks["jax"] == arks["torch"]


def test_double_matrix_reads_equal(tmp_path):
    """A DM record (as Kaldi writes double matrices) reads to the same
    float32 matrix in both packages."""
    mat = np.random.RandomState(2).randn(7, 5)
    path = str(tmp_path / "d.ark")
    with open(path, "wb") as f:
        f.write(b"k1 \x00BDM \x04" + struct.pack("<i", 7) + b"\x04"
                + struct.pack("<i", 5) + mat.astype("<f8").tobytes())
    (jk, ja), = list(jkio.read_ark(path))
    (tk, ta), = list(tkio.read_ark(path))
    assert jk == tk == "k1" and ta.dtype == np.float32
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ta, mat.astype(np.float32))


# -------------------------------------------------------- train/transforms

def test_svd_factor_equals_jax():
    w = np.random.RandomState(3).randn(12, 9).astype(np.float32)
    for rank in (3, 9, 20):
        for a, b in zip(ttr.svd_factor(w, rank), jtr.svd_factor(w, rank)):
            np.testing.assert_array_equal(a, b)


def test_svd_reduce_bottleneck_equals_jax():
    """The port's params (tensors) through svd_reduce_bottleneck: the
    same config and arrays as JAX's on the same numpy params, the other
    leaves shared unchanged."""
    kw = dict(feat_dim=8, ivector_dim=0, hidden_dim=24, bottleneck_dim=10,
              time_strides=(1, 0, 3), num_pdfs=7, prefinal_big=24,
              prefinal_small=12, compute_dtype="float32")
    jcfg, tcfg = jtdnnf.TdnnfModelConfig(**kw), ttdnnf.TdnnfModelConfig(**kw)
    params, bn = jtdnnf.init_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    dims = (4, 10, 6)
    jnew_cfg, jnew = jtr.svd_reduce_bottleneck(jcfg, params, dims)
    tparams = convert.tree_to_torch(params, "cpu")
    tnew_cfg, tnew = ttr.svd_reduce_bottleneck(tcfg, tparams, dims)
    assert tnew_cfg.bottleneck_dims == jnew_cfg.bottleneck_dims == dims
    assert tnew_cfg.bottleneck_dim == jnew_cfg.bottleneck_dim
    for name in ("tdnnf2", "tdnnf3", "tdnnf4"):
        for k in ("linear", "affine"):
            np.testing.assert_array_equal(tnew[name][k].numpy(),
                                          jnew[name][k])
        assert tnew[name]["affine_b"] is tparams[name]["affine_b"]
    assert tnew["prefinal_l"] is tparams["prefinal_l"]
    with pytest.raises(ValueError):
        ttr.svd_reduce_bottleneck(tcfg, tparams, (4, 4))


# -------------------------------------------------------------- graphs/wpd

def test_wpd_marks_equal_jax():
    prons = {0: (3,), 1: (1, 2), 2: (4, 0, 2, 1), 3: (5, 5, 5)}
    words = [2, 0, 1, 3, 0]
    assert twpd.num_marked_phones(6) == jwpd.num_marked_phones(6) == 24
    assert twpd.mark_lexicon(prons) == jwpd.mark_lexicon(prons)
    assert (twpd.mark_word_stream(words, prons)
            == jwpd.mark_word_stream(words, prons))
    assert (twpd.positions_of_stream(words, prons)
            == jwpd.positions_of_stream(words, prons))
    for m in range(24):
        assert twpd.unmark(m) == jwpd.unmark(m)
        assert twpd.mark(*twpd.unmark(m)) == m
