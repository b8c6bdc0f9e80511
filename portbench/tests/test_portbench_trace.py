"""The traced run's reduction from device events to metrics, on events
made up by hand."""

from portbench import trace
from portbench.metrics import (blocked_den_roofline, dense_den_roofline,
                               gemm_ms, idle_share, input_wait_ms,
                               launches_per_step, other_kernel_ms,
                               semiorth_extra_ms)

KERNELS = [
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT", 0.0, 10.0),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 12.0, 20.0),
    ("void (anonymous namespace)::fwd_scan<float>((anonymous "
     "namespace)::FwdArgs<float>)", 20.0, 50.0),
    ("void (anonymous namespace)::bwd_scan<float>((anonymous "
     "namespace)::BwdArgs<float>)", 60.0, 100.0),
    ("void at::native::elementwise_kernel<128, 2>", 95.0, 110.0),
]
HOST = [("aten::index_select", 9.0, 13.0), ("aten::mm", 49.0, 70.0),
        ("aten::copy_", 55.0, 58.0)]


def test_classes():
    assert [trace.kernel_class(n) for n, _, _ in KERNELS] == [
        "gemm", "gemm", "blocked_den", "blocked_den", "other"]
    assert trace.kernel_class(
        "void (anonymous namespace)::scan((anonymous namespace)::Args)"
    ) == "dense_den"
    assert trace.kernel_class(
        "void (anonymous namespace)::scan<true, false>((anonymous "
        "namespace)::Args)") == "dense_den"
    assert trace.kernel_class("DeviceScanKernel<int>") == "other"


def test_summary_and_readers():
    s = trace.summarise(KERNELS, [("Memcpy HtoD", 0.0, 5.0)], HOST, steps=1)
    # union: [0, 10], [12, 50], [60, 110] -> 98 us busy of 110
    assert s["busy_s"] == 98e-6 and s["window_s"] == 110e-6
    assert s["breakdown"]["idle_gaps"][0] == ["aten::copy_", 10e-6]
    assert s["breakdown"]["idle_gaps"][1] == ["aten::index_select", 2e-6]
    assert len(s["breakdown"]["device_ops"]) == 6
    rec = {"profile": s, "flops": {"den_class": "blocked_den",
                                   "den_ops": 495e12 * 7e-6,
                                   "den_bytes": 3.35e12 * 3.5e-6}}
    assert abs(idle_share.read(rec) - 100 * 12 / 110) < 1e-9
    assert launches_per_step.read(rec) == 5
    assert abs(gemm_ms.read(rec) - 0.018) < 1e-12
    assert abs(other_kernel_ms.read(rec) - 0.015) < 1e-12
    # least time 7 us (operations) of the pair's 70 us
    assert abs(blocked_den_roofline.read(rec) - 10.0) < 1e-9
    assert dense_den_roofline.read(rec) is None


def test_readers_with_nothing_to_read():
    rec = {"profile": None, "wait_s": [], "flops": {"den_class": "x"}}
    for reader in (idle_share, launches_per_step, gemm_ms, other_kernel_ms,
                   blocked_den_roofline, input_wait_ms):
        assert reader.read(rec) is None
    assert trace.summarise([], [], [], 1) is None


def test_semiorth_extra():
    rec = {"semiorth_interval": 4, "step_index": list(range(4, 12)),
           "step_ms": [30.0, 10.0, 11.0, 12.0, 32.0, 10.0, 11.0, 12.0]}
    assert semiorth_extra_ms.read(rec) == 31.0 - 11.0
