"""The analytic counters against hand counts and against torch's
FlopCounterMode over the port's own forward and backward on tiny
configurations and on the flagship's widths."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.flops import blocked_den, dense_den, supernet, tdnnf
from portbench.tests import tiny

FLAGSHIP_CONFIG = harness.load_json(
    harness.ROOT / "portbench/configs/tdnnf7q-left2-4gram.json")
FLAGSHIP = FLAGSHIP_CONFIG["model"]


def test_7q_forward_hand_count():
    # B = 1, 50 output frames: 216 input frames, lda and tdnn1 on 214;
    # each stride-1 layer's linear and affine take one frame off each
    g = tdnnf.forward_gemms(FLAGSHIP, 1, 50)
    assert g[0] == (214, 220, 220) and g[1] == (214, 220, 1536)
    assert g[2] == (213, 3072, 160) and g[3] == (212, 320, 1536)
    # the stride-0 layer runs at the subsampled rate on 70 frames
    assert g[8] == (70, 1536, 160) and g[9] == (70, 160, 1536)
    assert g[-1] == (50, 256, 6034)
    assert len(g) == 2 + 28 + 7


def test_7q_required_flops_b64():
    # 603.7 GFLOP a step at B = 64 (XLA's whole-step count: 632.3)
    assert abs(tdnnf.train_flops(FLAGSHIP, 64, 50) - 603.68613376e9) < 1e3


def _program_flops(cfg, supernet_kind):
    from portbench.kinds import supernet as ks
    from portbench.kinds import tdnnf as kt

    kind = ks if supernet_kind else kt
    params = harness.make_weights(kind.weights_spec(cfg), 3,
                                  torch.device("cpu"))
    k = cfg["model"].get("max_stride", 0) + 1
    left = 1 + (k - 1) * 14 if supernet_kind else 1 + sum(
        cfg["model"]["time_strides"])
    t_in = tdnnf.input_frames(cfg["model"], cfg["egs"]["chunk_width"], left)
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(2, t_in, cfg["model"]["feat_dim"], generator=g)
    iv = torch.randn(2, cfg["model"]["ivector_dim"], generator=g)
    model_cfg = kind.model_config(cfg)
    leaves = [x.requires_grad_(True) for _, x in
              __import__("portbench.reference.train", fromlist=["leaves"])
              .leaves(params)]
    from tdnnf_nas_torch.models import apply_model, apply_supernet
    from tdnnf_nas_torch.models.tdnnf import _init_bn_state

    bn = _init_bn_state(model_cfg.base if supernet_kind else model_cfg,
                        "cpu")
    with FlopCounterMode(display=False) as fc:
        if supernet_kind:
            alphas = {"offsets_linear": torch.zeros(14, k),
                      "offsets_affine": torch.zeros(14, k)}
            chain, xent, _, _ = apply_supernet(
                model_cfg, params, alphas, bn, feats, None, mode="uniform",
                generator=torch.Generator().manual_seed(1), train=True)
        else:
            chain, xent, _ = apply_model(model_cfg, params, bn, feats, iv,
                                         train=True)
        torch.autograd.grad((chain ** 2).sum() + (xent ** 2).sum(), leaves)
    return fc.get_total_flops()


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_7q_count_equals_flop_counter_on_the_port(which):
    # the flagship at its published widths, B = 2, on the CPU (~4 s)
    cfg = tiny.CONFIGS["tiny-7q"] if which == "tiny" else FLAGSHIP_CONFIG
    assert _program_flops(cfg, False) == tdnnf.train_flops(
        cfg["model"], 2, cfg["egs"]["chunk_width"])


def test_supernet_launched_count_equals_flop_counter_on_the_port():
    """The port computes every branch: its GEMMs match the count with
    branches=K, and the required count (share + sampled) is smaller."""
    cfg = tiny.CONFIGS["tiny-supernet"]
    k = cfg["model"]["max_stride"] + 1
    w = cfg["egs"]["chunk_width"]
    launched = supernet.train_flops(cfg["model"], 2, w, branches=k)
    assert _program_flops(cfg, True) == launched
    assert supernet.train_flops(cfg["model"], 2, w) < launched


def test_den_counts():
    ops, nbytes = blocked_den.ops_bytes(2, 3, 10, 40, obs_bytes=2)
    assert ops == 3 * 2 * 3 * (2 * 40 + 3 * 10)
    assert nbytes == 2 * 3 * 10 * 6 + 12 * 40 + 80
    ops, nbytes = dense_den.ops_bytes(2, 3, 10, 40)
    assert ops == 3 * 2 * 3 * (2 * 40 + 3 * 10)
    assert nbytes == 2 * 3 * 10 * 8 + 12 * 40 + 80
