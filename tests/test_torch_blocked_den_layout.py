"""Host-side pieces of the blocked-den kernels that run without a GPU: the
16-byte row padding of W, and the phase tool's instrumentation of the
kernels' source."""

import numpy as np
import pytest
import torch

from tdnnf_nas_torch.graphs.den_graph import random_blocked_graph
from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph
from tdnnf_nas_torch.tools import blocked_den_phases


def _graph(nsrc, ndpos, r):
    rng = np.random.RandomState(0)
    return BlockedDenGraph.from_host(
        random_blocked_graph(rng, 2, nsrc, ndpos, r, 20), "cpu")


def test_w_rows_padded_to_16_bytes_and_kept():
    g = _graph(9, 5, 2)  # NDP = 19
    w = bdc._w_rows16(g)
    assert w.shape == (2, 9, 20) and w.is_contiguous()
    assert torch.equal(w[:, :, :19], g.w_blocks)
    assert not bool(w[:, :, 19:].any())
    assert bdc._w_rows16(g) is w  # made once per graph
    g.w_blocks.mul_(2.0)  # a new version of W is padded anew
    w2 = bdc._w_rows16(g)
    assert w2 is not w and torch.equal(w2[:, :, :19], g.w_blocks)


def test_w_rows_already_aligned_are_not_copied():
    g = _graph(8, 4, 2)  # NDP = 16
    assert bdc._w_rows16(g) is g.w_blocks


@pytest.mark.parametrize("variant", sorted(blocked_den_phases.VARIANTS))
def test_phase_tool_instruments_the_kernels(variant):
    src = bdc._SRC.read_text()
    out = blocked_den_phases.instrumented_source(src, variant)
    assert out.count("%globaltimer") == 3  # every barrier, both kernels
    assert "phases_read" in out


# V = C * (R * NDPOS + NSRC) of the dens chip_smoke.py holds the blocked
# pair to (its [den fwd] lines), and their GFLOP at one decimal
_DEN_V_GFLOP = {"flagship": (18830, 63.5), "b16": (14568, 11.2),
                "b48": (4850, 5.1), "pm1": (61468, 215.5),
                "ctx": (58044, 118.4)}


@pytest.mark.parametrize("shape", sorted(_DEN_V_GFLOP))
def test_phase_tool_shapes_match_the_dens(shape):
    """Each of the phase tool's shapes has the V and the product work of
    the den it stands for, and the instrumented kernels take it."""
    b, t, c, nsrc, ndpos, r, _, groups = blocked_den_phases.SHAPES[shape]
    v, gflop = _DEN_V_GFLOP[shape]
    ndp = r * ndpos + nsrc
    assert c * ndp == v
    flops = 2.0 * b * (c * nsrc * ndp + groups * v) * (t - 1)
    assert round(flops / 1e9, 1) == gflop
    src = blocked_den_phases.instrumented_source(bdc._SRC.read_text(), "base")
    assert "phases_read" in src
