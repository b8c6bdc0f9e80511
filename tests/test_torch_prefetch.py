"""The port's batch staging (``parallel/mesh.py``) and ``train_model``'s
input paths on the CPU: the bf16 payload against the reference's
``ml_dtypes`` cast, the prefetcher's CPU conversion, ``train_model`` with
and without prefetch, and fed from a TEGS shard with checkpoints.

The prefetcher's CUDA path (pinned buffers, side stream, events) is held
in tests/test_torch_cuda_prefetch.py on the card.
"""

import numpy as np
import pytest
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.parallel import compress_batch_bf16, prefetch_to_device
from tdnnf_nas_torch.train.optimizer import tree_paths

torch.set_num_threads(1)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def test_compress_bf16_bits_match_ml_dtypes():
    """Round to nearest even, as the reference's ``ml_dtypes`` cast: random
    values over 60 binades, exact ties both ways, signed zeros,
    infinities, the largest finite values and float32 subnormals."""
    import ml_dtypes

    rng = np.random.RandomState(0)
    x = (rng.randn(3991) * np.exp2(rng.randint(-30, 30, 3991))).astype(
        np.float32)
    # finite bf16 bit patterns (exponent below 0xFF) with a tie or near-tie
    # in the 16 low bits
    base = rng.randint(1, 0x7F80, 200).astype(np.uint32) << 16
    ties = np.concatenate([base | 0x8000, base | 0x18000, base | 0x7FFF,
                           base | 0x8001]).view(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 3.4028235e38,
                        -3.3961776e38, 1e-40, -1e-45, 1.17549435e-38],
                       np.float32)
    feats = np.concatenate([x, ties, special]).reshape(2, -1, 3)
    iv = rng.randn(2, 5).astype(np.float32)
    batch = {"feats": feats, "ivectors": iv, "sup": object()}
    out = compress_batch_bf16(batch)
    assert out["sup"] is batch["sup"] and batch["feats"] is feats
    for k, v in (("feats", feats), ("ivectors", iv)):
        assert out[k].dtype == torch.bfloat16 and out[k].shape == v.shape
        np.testing.assert_array_equal(
            _bf16_bits(out[k]), v.astype(ml_dtypes.bfloat16).view(np.int16),
            err_msg=k)


def test_compress_bf16_matches_reference_on_a_batch():
    """The reference's ``compress_batch_bf16`` and the port's on one host
    batch: feats cast, the supervision's arrays untouched."""
    from tdnnf_nas_tpu.parallel.mesh import compress_batch_bf16 as jcompress
    from tests.test_torch_dense_train_step import _build

    _, _, batch = _build("torch")
    j, t = jcompress(batch), compress_batch_bf16(batch)
    np.testing.assert_array_equal(_bf16_bits(t["feats"]),
                                  j["feats"].view(np.int16))
    assert t["sup"] is j["sup"] is batch["sup"]
    assert "ivectors" not in t


def test_prefetch_on_cpu_only_converts():
    """On the CPU the prefetcher yields ``batch_to_torch`` of each batch
    (bf16 feats with the payload option), in order, and nothing more;
    without ``device`` it needs a card, as every entry point."""
    from tests.test_torch_dense_train_step import _build
    from tdnnf_nas_torch.data import batch_iterator

    bundle, cfg, _ = _build("torch")
    chunks = bundle.egs(cfg, chunk_width=16, max_phones_per_chunk=12)
    host = list(batch_iterator(chunks, batch_size=4,
                               rng=np.random.RandomState(1), epochs=1))[:3]
    for bf16 in (False, True):
        got = list(prefetch_to_device(iter(host), size=2, device="cpu",
                                      payload_bf16=bf16))
        assert len(got) == 3
        for g, h in zip(got, host):
            want = convert.batch_to_torch(h, device="cpu")
            assert g["feats"].dtype == (torch.bfloat16 if bf16
                                        else torch.float32)
            assert torch.equal(g["feats"].float(),
                               want["feats"].to(g["feats"].dtype).float())
            for f in ("trans", "state_pdf", "init", "final", "mask",
                      "next_w"):
                a, b = getattr(g["sup"], f), getattr(want["sup"], f)
                assert a.dtype == b.dtype and torch.equal(a, b), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            prefetch_to_device(iter(host))


@pytest.fixture(scope="module")
def mini():
    """The small dense setup: bundle and the plain model config."""
    from tests.test_torch_dense_train_step import _build

    bundle, cfg, _ = _build("torch")
    return bundle, cfg


def _assert_same_run(a, b):
    (sa, la), (sb, lb) = a, b
    assert la.series == lb.series
    for name in ("params", "bn_state", "opt_state"):
        for (p, x), (_, y) in zip(tree_paths(getattr(sa, name)),
                                  tree_paths(getattr(sb, name))):
            assert torch.equal(x, y), (name, p)
    assert sa.step == sb.step


def test_train_model_prefetch_equals_no_prefetch(mini):
    """``train_model`` with ``prefetch=2`` gives the run of ``prefetch=0``
    bit for bit (same batches, same order, same steps)."""
    from tdnnf_nas_torch.recipes import train_model
    from tdnnf_nas_torch.train import TrainerConfig

    bundle, cfg = mini
    kw = dict(batch_size=4, chunk_width=16, seed=3, device="cpu")
    runs = [train_model(bundle, cfg, TrainerConfig(), 3, prefetch=p, **kw)
            for p in (0, 2)]
    assert len(runs[0][1].series["objf_mmi"]) == 3
    _assert_same_run(*runs)


def test_train_model_from_egs_shard_with_checkpoints(mini, tmp_path):
    """``train_model(egs_path=...)``: batches come from the shard's native
    loader seeded ``seed`` (the same steps as a loop over that loader),
    through the prefetcher; checkpoints every 3 steps and after the last,
    the configs in their meta."""
    from tdnnf_nas_torch.core.checkpoint import latest_step, load_checkpoint
    from tdnnf_nas_torch.core.config import config_from_dict
    from tdnnf_nas_torch.data.egs_file import NativeEgsLoader, write_egs_file
    from tdnnf_nas_torch.models import TdnnfModelConfig
    from tdnnf_nas_torch.recipes import train_model
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.train import (TrainerConfig, init_train_state,
                                       make_train_step)

    bundle, cfg = mini
    shard = str(tmp_path / "train.tegs")
    write_egs_file(bundle.egs(cfg, chunk_width=16, max_phones_per_chunk=12),
                   shard)
    tc = TrainerConfig()
    ck = str(tmp_path / "ck")
    state, log = train_model(bundle, cfg, tc, 4, batch_size=4, seed=2,
                             egs_path=shard, ckpt_dir=ck, ckpt_interval=3,
                             device="cpu")
    objf = [v for _, v in log.series["objf_mmi"]]
    assert len(objf) == 4 and np.all(np.isfinite(objf))

    ref = init_train_state(cfg, tc, torch.Generator().manual_seed(2), "cpu")
    step = make_train_step(cfg, tc, den_on_device(bundle, "cpu"), seed=3)
    loader = NativeEgsLoader(shard, 4, seed=2)
    try:
        it = iter(loader)
        ref_objf = []
        for _ in range(4):
            ref, m = step(ref, convert.batch_to_torch(next(it), "cpu"))
            ref_objf.append(float(m["objf_mmi"]))
    finally:
        loader.close()
    assert ref_objf == objf
    assert latest_step(ck) == 4
    assert sorted(p.name for p in (tmp_path / "ck").glob("*.npz")) == [
        "ckpt_00000003.npz", "ckpt_00000004.npz"]
    loaded, step_no, meta = load_checkpoint(ck, ref)
    assert step_no == 4 and loaded.step == 4
    _assert_same_run((loaded, log), (state, log))
    assert config_from_dict(TdnnfModelConfig, meta["model"]) == cfg
    assert config_from_dict(TrainerConfig, meta["trainer"]) == tc
    assert meta["supernet"] is False
