#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tdnnf_nas_torch``) on one NVIDIA GPU.

Drives the port's two training paths, the flagship step fed from a TEGS
shard through the native loader and the prefetcher, and its
architecture search: a few LF-MMI steps each of the
flagship TDNN-F 7q model (random seeded weights) on 64 x 150-frame
chunks: against the production 4-gram x left-2 triphone blocked
denominator (10,271 states, 6,034 pdfs, 18,751,248 params), and against
the bigram x left-biphone dense denominator (2,208 states, 2,208 pdfs,
16,784,684 params), then the two-stage DARTS search against the dense
den.  Checks the hand-written CUDA kernels of each path against their
plain PyTorch versions.  Phases, each raising on failure:

  0. build both kernel libraries from ``tdnnf_nas_torch/csrc`` (one nvcc
     per source, started together, sm_90a);
  1. flagship host setup (the ``bench.py`` setup, through the port's own
     numpy host modules): 10,271 den states, 18,751,248 params;
  2. kernel vs plain at the flagship den shape, float32 and bf16 obs,
     with each tolerance and its reason; kernel and plain timings, the
     scan's block products alone in cuBLAS (``library_ms``), the bound
     and the device launches of one scan (profiler);
  3. training: launch counters reset, then 8 bf16 steps with
     ``den_obs_bf16``; objf finite at every step, both kernels launched
     once per step; ms/step and the device kernel launches of one step
     (profiler);
  4. one float32 step through the kernels against the same step through
     the plain den, from the same state;
  5. the dense biphone flagship on phase 1's corpus: host setup (2,208
     den states and pdfs, 16,784,684 params); dense-den kernels vs plain
     at B=64, T=50, S=2,208 in float32, with timings, ``library_ms``, the
     bound and the device launches of one scan (one each, checked), the
     kernel and cuBLAS times at the search's B=32 beside them; launch
     counters reset, then 6 bf16 steps with the default objective config (objf
     and grad_norm finite, both kernels launched once per step, ms/step);
     one float32 kernel step against the same step through the plain den;
  6. the two-stage DARTS search on phase 5's biphone bundle and den: the
     offsets supernet (K = 7 branches x 14 layers, 51,494,904 params,
     context (85, 85), B = 32) with launch counters reset: 2 warm-up and
     4 timed uniform steps, theta only (ms/step, peak memory); stage A's
     state handed to stage B through a checkpoint (``save_checkpoint`` /
     ``load_checkpoint`` in a temporary directory, the loaded state
     checked leaf for leaf); 3 gumbel alpha-only steps on the dev split
     with theta and BN frozen (checked bit for bit); top-3 extraction and 2 bf16 steps of the child; the
     bottleneck supernet (23,232,504 params, context (34, 34)): 2 uniform
     and 2 gumbel alpha-only steps with the FLOPs penalty; one float32
     softmax supernet step through the kernels against the same step
     through the plain den.  Every supernet step launches each dense
     kernel once; each run after stage A times its steps after the
     first;
  7. (run last, on phase 1's chunks, blocked den and first batch, kept
     for it) the reference bench's headline path (``bench.py:180-237``): phase 1's chunks written to a
     TEGS shard, streamed by the native loader (``egs_loader.cc`` built
     by g++; batch 64, queue depth 6, seed 0) with synthetic i-vectors
     through the CUDA-stream prefetcher (size 3, bf16 payload) into the
     bf16 step; launch counters reset, 2 warm-up steps, then 3
     alternating rounds of 30 loader-fed and 30 resident steps (ms/step
     and audio-s/s ranges; objf and grad_norm finite; each blocked
     kernel launched once per step) and the card's idle share over 2
     profiled steps of each; under deterministic algorithms, bit for
     bit: a bf16-payload step against its float32-payload step,
     prefetched batches against synchronous copies, and a step after a
     checkpoint round trip against the step of the unbroken state (with
     the .npz size).

Prints the card's name and power limit, one JSON line of per-kernel
results (with ``bound_ms``, ``bound_by``, ``library_ms``, the bound of
three TF32 tensor-core passes ``bound_ms_3xtf32`` and
``launches_per_scan``), and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Exits non-zero,
printing no result, without a CUDA device or without the repository.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
_TPU_KERNELS = "tdnnf_nas_tpu/ops/pallas_fwdbwd.py"


def _gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int = 3) -> float:
    """Mean device time of fn() in ms over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"smoke check failed: {what}")


# Published peaks of one H100 SXM (NVIDIA's data sheet) for bound_ms:
# float32 outside the tensor cores, dense TF32 on them, device memory.
_PEAK_F32_FLOPS = 67e12
_PEAK_TF32_FLOPS = 495e12
_PEAK_BYTES = 3.35e12


def _bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the float32
    peak and bytes over the memory rate."""
    t_ops, t_mem = flops / _PEAK_F32_FLOPS, nbytes / _PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def _bound_3xtf32(flops: float, nbytes: float) -> float:
    """The bound on the unit the kernels' products run on: three TF32
    tensor-core passes (3xTF32) of the float32 product at the dense TF32
    peak, or the bytes over the memory rate, whichever is larger (ms)."""
    return max(3.0 * flops / _PEAK_TF32_FLOPS, nbytes / _PEAK_BYTES) * 1e3


def _device_launches(torch, fn, attempts: int = 3):
    """Device kernels one fn() call launches (memsets and copies apart),
    read from torch.profiler after a warm-up call; None if the profiler
    sees no device activity in any of ``attempts`` profiles (on the
    card it now and then records none for a whole profile, so a profile
    without device events is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            return sum(not e.name.startswith(("Memset", "Memcpy"))
                       for e in dev)
    return None


def _library_ms(torch, mm, t: int) -> float:
    """Device time of a scan's products alone through cuBLAS: t - 1 calls
    of mm(), timed over the whole loop (the yardstick; the port never
    calls it)."""
    return _cuda_ms(torch, lambda: [mm() for _ in range(t - 1)])


def _dense_phase(torch, dev, gpu, utts, phone_seqs, topo, iv_rng):
    """Phase 5, the dense biphone flagship; returns its two kernel rows."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.graphs import BiphoneTree
    from tdnnf_nas_torch.models import TdnnfModelConfig, count_params
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import _MIN_LOG_OBS, DenGraphArrays
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)

    # ---- 5.1 host setup (bench.py:290-299) ----
    t0 = time.perf_counter()
    batch_size, chunk_width, num_phones = 64, 50, 46
    tree = BiphoneTree(num_phones, num_leaves=6034 - num_phones)
    bundle = prepare_data(utts, phone_seqs, tree, topo, num_phones)
    model_cfg = TdnnfModelConfig(num_pdfs=tree.num_pdfs)
    chunks = bundle.egs(model_cfg, chunk_width=chunk_width,
                        max_phones_per_chunk=40)
    host_batches = []
    for b in batch_iterator(chunks, batch_size=batch_size,
                            rng=np.random.RandomState(0), drop_last=False):
        if len(host_batches) >= 6 or b["feats"].shape[0] != batch_size:
            break
        b["ivectors"] = iv_rng.randn(batch_size, model_cfg.ivector_dim
                                     ).astype(np.float32)
        host_batches.append(b)
    print(f"[dense setup] {time.perf_counter() - t0:.1f} s: "
          f"pdfs={tree.num_pdfs} den_states={bundle.den.num_states} "
          f"chunks={len(chunks)} batches={len(host_batches)}", flush=True)
    _check(bundle.den.num_states == 2208, "2,208 dense den states")
    _check(tree.num_pdfs == 2208, "2,208 biphone pdfs")
    _check(bundle.den_fsa is None, "the dense (non-composed) branch")
    _check(len(host_batches) == 6, "6 full batches")
    g = DenGraphArrays.from_graph(bundle.den, dev)
    batches = [convert.batch_to_torch(b, dev) for b in host_batches]

    # ---- 5.2 kernel vs plain at B=64, T=50, S=2,208, float32 ----
    # Tolerances as in phase 2: the kernels sum in another order than
    # cuBLAS and torch (no atomics: runs repeat bit for bit); logZ sums 50
    # per-frame log-scales of ~1e-6 relative error each: |dlogZ| <= 1e-3;
    # the log-obs gradient within 1e-3 of its largest entry.
    rng = np.random.RandomState(5)
    logits = torch.tensor(rng.randn(batch_size, chunk_width, tree.num_pdfs)
                          .astype(np.float32) * 2.0, device=dev)
    obs = torch.clamp(logits - logits.amax(-1, keepdim=True),
                      min=_MIN_LOG_OBS).index_select(-1, g.state_pdf)
    obs = obs.contiguous()
    gbar = torch.tensor(rng.rand(batch_size).astype(np.float32) + 0.5,
                        device=dev)
    leaky = 0.1
    z_k, al_k, cs_k = ddc.dense_den_fwd_cuda(obs, g.trans, g.init, g.final,
                                             leaky)
    gr_k = ddc.dense_den_bwd_cuda(obs, g.trans, g.final, al_k, cs_k, gbar)
    z_k2, al_k2, cs_k2 = ddc.dense_den_fwd_cuda(obs, g.trans, g.init,
                                                g.final, leaky)
    gr_k2 = ddc.dense_den_bwd_cuda(obs, g.trans, g.final, al_k2, cs_k2, gbar)
    z_p, al_p, cs_p = ddc.dense_scan_fwd_plain(obs, g.trans, g.init, g.final,
                                               leaky)
    gr_p = ddc.dense_scan_bwd_plain(obs, g.trans, g.final, al_p, cs_p, gbar)
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(z_k).all() and torch.isfinite(gr_k).all()),
           "finite dense kernel outputs")
    _check(bool(torch.equal(z_k, z_k2) and torch.equal(al_k, al_k2)
                and torch.equal(gr_k, gr_k2)),
           "dense kernel runs repeat bit for bit")
    err_z = float((z_k - z_p).abs().max())
    err_g = float((gr_k - gr_p).abs().max())
    gmax = float(gr_p.abs().max())
    err_a = float((al_k - al_p).abs().max())
    print(f"[dense kernel-vs-plain f32] logZ max|err|={err_z:.3e} (tol 1e-3, "
          f"|logZ|~{float(z_p.abs().mean()):.1f}); alphas max|err|="
          f"{err_a:.3e}; grad max|err|={err_g:.3e} (tol 1e-3 x max|grad|="
          f"{gmax:.3e})", flush=True)
    _check(err_z <= 1e-3, "dense logZ within 1e-3")
    _check(err_g <= 1e-3 * max(gmax, 1.0), "dense grad within tol")
    times = {
        "fwd": _cuda_ms(torch, lambda: ddc.dense_den_fwd_cuda(
            obs, g.trans, g.init, g.final, leaky)),
        "fwd_plain": _cuda_ms(torch, lambda: ddc.dense_scan_fwd_plain(
            obs, g.trans, g.init, g.final, leaky)),
        "bwd": _cuda_ms(torch, lambda: ddc.dense_den_bwd_cuda(
            obs, g.trans, g.final, al_k, cs_k, gbar)),
        "bwd_plain": _cuda_ms(torch, lambda: ddc.dense_scan_bwd_plain(
            obs, g.trans, g.final, al_p, cs_p, gbar)),
    }
    print(f"[dense den timing, f32, B={batch_size} T={chunk_width} "
          f"S={g.trans.shape[0]}] fwd kernel {times['fwd']:.3f} ms vs plain "
          f"{times['fwd_plain']:.3f} ms; bwd kernel {times['bwd']:.3f} ms vs "
          f"plain {times['bwd_plain']:.3f} ms ({gpu})", flush=True)
    # yardstick: the scan's products alone in cuBLAS (float32, TF32 off);
    # bound: 2*B*S^2 flops a product frame against obs, alphas (and grad)
    # and trans moved once
    s = g.trans.shape[0]
    x = torch.rand(batch_size, s, device=dev)
    y = torch.empty_like(x)
    lib = {"fwd": _library_ms(torch, lambda: torch.mm(x, g.trans, out=y),
                              chunk_width),
           "bwd": _library_ms(torch, lambda: torch.mm(x, g.trans.T, out=y),
                              chunk_width)}
    flops = 2.0 * batch_size * s * s * (chunk_width - 1)
    plane = 4.0 * batch_size * chunk_width * s
    moved = {"fwd": 2 * plane + 4.0 * s * s, "bwd": 3 * plane + 4.0 * s * s}
    bound = {k: _bound(flops, v) for k, v in moved.items()}
    bound_tc = {k: _bound_3xtf32(flops, v) for k, v in moved.items()}
    per_scan = {
        "fwd": _device_launches(torch, lambda: ddc.dense_den_fwd_cuda(
            obs, g.trans, g.init, g.final, leaky)),
        "bwd": _device_launches(torch, lambda: ddc.dense_den_bwd_cuda(
            obs, g.trans, g.final, al_k, cs_k, gbar)),
    }
    # the search's batch (phase 6): B = 32, same T and S
    b32 = batch_size // 2
    obs32, gbar32 = obs[:b32].contiguous(), gbar[:b32].contiguous()
    _, al32, cs32 = ddc.dense_den_fwd_cuda(obs32, g.trans, g.init, g.final,
                                           leaky)
    x32, y32 = x[:b32].contiguous(), y[:b32].contiguous()
    times32 = {
        "fwd": _cuda_ms(torch, lambda: ddc.dense_den_fwd_cuda(
            obs32, g.trans, g.init, g.final, leaky)),
        "bwd": _cuda_ms(torch, lambda: ddc.dense_den_bwd_cuda(
            obs32, g.trans, g.final, al32, cs32, gbar32))}
    lib32 = {"fwd": _library_ms(torch, lambda: torch.mm(
                 x32, g.trans, out=y32), chunk_width),
             "bwd": _library_ms(torch, lambda: torch.mm(
                 x32, g.trans.T, out=y32), chunk_width)}
    for k in ("fwd", "bwd"):
        print(f"[dense den {k}] B={batch_size}: kernel {times[k]:.3f} ms, "
              f"cuBLAS products alone {lib[k]:.3f} ms; B={b32}: kernel "
              f"{times32[k]:.3f} ms, cuBLAS {lib32[k]:.3f} ms; bound "
              f"(B={batch_size}) {bound[k][0]:.3f} ms ({bound[k][1]}), "
              f"3xTF32 bound {bound_tc[k]:.3f} ms; device launches per scan "
              f"{per_scan[k]} ({gpu})", flush=True)
        _check(per_scan[k] == 1, f"dense {k}: one device kernel per scan")
    del al_k, al_k2, al_p, gr_k, gr_k2, gr_p, logits, x, y
    del al32, obs32, x32, y32

    # ---- 5.3 training: the dense main path (a dense den always takes
    # the kernels; the default config shows no switch is needed) ----
    trainer_cfg = TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=1e-4, num_steps=100000))
    state = init_train_state(model_cfg, trainer_cfg,
                             torch.Generator().manual_seed(0), dev)
    n_params = count_params(state.params)
    print(f"[dense model] params={n_params:,}", flush=True)
    _check(n_params == 16_784_684, "16,784,684 params")
    step = make_train_step(model_cfg, trainer_cfg, g)
    ddc.dense_den_fwd_cuda.launches = 0
    ddc.dense_den_bwd_cuda.launches = 0
    ms = []
    n_warm, n_timed = 2, 4
    for i in range(n_warm + n_timed):
        if i == n_warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, batches[i])
        ms.append(m)
        _check(ddc.dense_den_fwd_cuda.launches == i + 1
               and ddc.dense_den_bwd_cuda.launches == i + 1,
               "one launch of each dense kernel per step")
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    launches = {"fwd": ddc.dense_den_fwd_cuda.launches,
                "bwd": ddc.dense_den_bwd_cuda.launches}
    objfs = [float(m["objf_mmi"]) for m in ms]
    print("[dense train] objf_mmi per step: "
          + " ".join(f"{v:.4f}" for v in objfs), flush=True)
    _check(all(np.isfinite(objfs)), "dense objf_mmi finite at every step")
    _check(all(np.isfinite(float(m["grad_norm"])) for m in ms),
           "dense grad_norm finite at every step")
    print(f"[dense train] {dt * 1e3:.2f} ms/step over {n_timed} steps "
          f"(bf16, B={batch_size}x150 frames) = "
          f"{batch_size * chunk_width * 3 * 0.010 / dt:.1f} audio-s/s; "
          f"launches fwd={launches['fwd']} bwd={launches['bwd']} ({gpu})",
          flush=True)
    del state, step

    # ---- 5.4 kernel step vs plain step, float32 ----
    f32_cfg = model_cfg.replace(compute_dtype="float32")
    st0 = init_train_state(f32_cfg, trainer_cfg,
                           torch.Generator().manual_seed(1), dev)
    step32 = make_train_step(f32_cfg, trainer_cfg, g)
    _, m_k = step32(copy.deepcopy(st0), batches[0])
    n_before = (ddc.dense_den_fwd_cuda.launches,
                ddc.dense_den_bwd_cuda.launches)
    plain = lambda device: (ddc.dense_scan_fwd_plain,
                            ddc.dense_scan_bwd_plain)
    with mock.patch.object(ddc, "_scan_impl", plain):
        _, m_p = step32(copy.deepcopy(st0), batches[0])
    torch.cuda.synchronize()
    _check(n_before == (ddc.dense_den_fwd_cuda.launches,
                        ddc.dense_den_bwd_cuda.launches),
           "the plain dense step launched no kernel")
    d_objf = abs(float(m_k["objf_mmi"]) - float(m_p["objf_mmi"]))
    d_gn = abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"]))
    print(f"[dense f32 step] objf_mmi kernel={float(m_k['objf_mmi']):.9g} "
          f"plain={float(m_p['objf_mmi']):.9g} |d|={d_objf:.2e} (tol 1e-4); "
          f"grad_norm kernel={float(m_k['grad_norm']):.9g} "
          f"plain={float(m_p['grad_norm']):.9g} |d|={d_gn:.2e} "
          f"(tol 1e-3 relative)", flush=True)
    _check(d_objf <= 1e-4, "dense f32 objf kernel vs plain")
    _check(d_gn <= 1e-3 * max(float(m_p["grad_norm"]), 1.0),
           "dense f32 grad_norm kernel vs plain")

    src = "tdnnf_nas_torch/csrc/dense_den.cu"
    rows = [
        {"name": "dense_den_fwd", "route": "cuda", "source": src,
         "replaces": f"{_TPU_KERNELS}:74", "launches": launches["fwd"],
         "max_abs_err": err_z, "ms": times["fwd"],
         "plain_ms": times["fwd_plain"], "bound_ms": bound["fwd"][0],
         "bound_by": bound["fwd"][1], "library_ms": lib["fwd"],
         "bound_ms_3xtf32": bound_tc["fwd"],
         "launches_per_scan": per_scan["fwd"], "ms_b32": times32["fwd"],
         "library_ms_b32": lib32["fwd"]},
        {"name": "dense_den_bwd", "route": "cuda", "source": src,
         "replaces": f"{_TPU_KERNELS}:110", "launches": launches["bwd"],
         "max_abs_err": err_g, "ms": times["bwd"],
         "plain_ms": times["bwd_plain"], "bound_ms": bound["bwd"][0],
         "bound_by": bound["bwd"][1], "library_ms": lib["bwd"],
         "bound_ms_3xtf32": bound_tc["bwd"],
         "launches_per_scan": per_scan["bwd"], "ms_b32": times32["bwd"],
         "library_ms_b32": lib32["bwd"]},
    ]
    return rows, bundle, g


def _dense_launches(ddc):
    return (ddc.dense_den_fwd_cuda.launches, ddc.dense_den_bwd_cuda.launches)


def _blocked_launches(bdc):
    return (bdc.blocked_den_fwd_cuda.launches,
            bdc.blocked_den_bwd_cuda.launches)


@contextlib.contextmanager
def _deterministic(torch):
    """torch.use_deterministic_algorithms inside the block: the step's
    scatter-adds (the backward of its gathers and index_selects) take
    their deterministic implementations, so that equal inputs give equal
    bits.  ``warn_only``: cuBLAS only warns without
    ``CUBLAS_WORKSPACE_CONFIG``, which the script leaves unset, since
    with it set the host took longer to launch each GEMM (the cuBLAS
    yardsticks, 49 launches timed together, read 2-3x slower); one
    stream's GEMMs repeat bit for bit, and the phase checks that a step
    repeats."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _states_equal(torch, a, b) -> bool:
    """Leaf for leaf, bit for bit, the step counter included."""
    from tdnnf_nas_torch.train.optimizer import tree_paths

    for name in ("params", "alphas", "bn_state", "opt_state",
                 "alpha_opt_state"):
        pa, pb = tree_paths(getattr(a, name)), tree_paths(getattr(b, name))
        if [p for p, _ in pa] != [p for p, _ in pb]:
            return False
        if not all(x.dtype == y.dtype and torch.equal(x, y)
                   for (_, x), (_, y) in zip(pa, pb)):
            return False
    return a.step == b.step


def _metrics_equal(torch, a, b) -> bool:
    return set(a) == set(b) and all(
        torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])) for k in a)


def _idle_share(torch, fn):
    """(idle share, kernel ms, window ms) of the card over fn(): the
    share of the window from the first device kernel's start to the last
    one's end in which no kernel ran (copies and memsets apart), from
    torch.profiler; None if the profiler sees no kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith(("Memset", "Memcpy")))
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    return 1.0 - busy / window, busy / 1e3, window / 1e3


def _loader_phase(torch, dev, gpu, chunks, g, model_cfg, trainer_cfg,
                  resident):
    """Phase 7, the reference bench's headline path (bench.py:180-237)
    through the port: phase 1's flagship chunks written to a TEGS shard,
    read back by the native loader (batch 64, queue depth 6, seed 0) with
    bench.py's synthetic i-vectors, staged by the CUDA-stream prefetcher
    (size 3, bf16 payload) into the bf16 ``den_obs_bf16`` step.  Launch
    counters reset; 2 warm-up steps, then 3 alternating rounds of 30
    loader-fed and 30 resident steps (``resident``: one batch on the
    card), each closed by a host fetch of objf_mmi; the card's idle share
    over 2 profiled steps of each; then, under deterministic algorithms, a bf16-
    against a float32-payload step, prefetched against synchronous
    copies, and a checkpoint round trip against the unbroken state, each
    bit for bit.  Returns the blocked kernels' launches over the phase."""
    import tempfile

    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.core.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from tdnnf_nas_torch.core.config import asdict_config
    from tdnnf_nas_torch.data import native
    from tdnnf_nas_torch.data.egs_file import NativeEgsLoader, write_egs_file
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.parallel import (compress_batch_bf16,
                                          prefetch_to_device)
    from tdnnf_nas_torch.train import init_train_state, make_train_step

    # n_prof: steps profiled for the card's idle share, few: after the
    # earlier phases' profiles, a second profile of 5 steps in the same
    # process recorded only about half of its device kernels
    batch_size, n_warm, n_timed, rounds, n_prof = 64, 2, 30, 3, 2
    audio_s = batch_size * 50 * 3 * 0.010
    iv_rng = np.random.RandomState(3)

    def with_iv(b):
        b["ivectors"] = iv_rng.randn(b["feats"].shape[0],
                                     model_cfg.ivector_dim).astype(np.float32)
        return b

    td = tempfile.TemporaryDirectory()
    loader = None
    try:
        # ---- 7.0 shard and loader ----
        t0 = time.perf_counter()
        shard = os.path.join(td.name, "egs.tegs")
        write_egs_file(chunks, shard)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.get_lib()
        t_lib = time.perf_counter() - t0
        loader = NativeEgsLoader(shard, batch_size, queue_depth=6, seed=0)
        host = iter(loader)
        print(f"[loader] TEGS shard of {loader.num_chunks} chunks, "
              f"{os.path.getsize(shard):,} bytes, written in {t_write:.1f} s; "
              f"egs_loader.cc built and loaded in {t_lib:.1f} s "
              f"({native.library_path().name})", flush=True)

        def stream(n):
            for _ in range(n):
                yield with_iv(next(host))

        step = make_train_step(model_cfg, trainer_cfg, g)

        def loader_fed(state, n):
            m = None
            for b in prefetch_to_device(stream(n), size=3, device=dev,
                                        payload_bf16=True):
                _check(all(a.is_cuda for a in _batch_leaves(b)),
                       "the prefetcher hands the step card tensors")
                state, m = step(state, b)
            return state, m

        def resident_fed(state, n):
            m = None
            for _ in range(n):
                state, m = step(state, resident)
            return state, m

        # ---- 7.1 timed rounds, launch counters reset ----
        state = init_train_state(model_cfg, trainer_cfg,
                                 torch.Generator().manual_seed(0), dev)
        bdc.blocked_den_fwd_cuda.launches = 0
        bdc.blocked_den_bwd_cuda.launches = 0
        state, m = loader_fed(state, n_warm)
        _check(np.isfinite(float(m["objf_mmi"])), "warm-up objf finite")
        state, m = resident_fed(state, n_warm)
        _check(np.isfinite(float(m["objf_mmi"])), "warm-up objf finite")
        ms = {"loader": [], "resident": []}
        runs = {"loader": loader_fed, "resident": resident_fed}
        for r in range(rounds):
            for name in ("loader", "resident"):
                before = _blocked_launches(bdc)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = runs[name](state, n_timed)
                objf = float(m["objf_mmi"])  # the host fetch closes the time
                dt = (time.perf_counter() - t0) / n_timed
                ms[name].append(dt * 1e3)
                after = _blocked_launches(bdc)
                print(f"[loader round {r + 1}] {name}-fed: {dt * 1e3:.2f} "
                      f"ms/step, {audio_s / dt:.1f} audio-s/s over "
                      f"{n_timed} steps; objf_mmi {objf:.4f} grad_norm "
                      f"{float(m['grad_norm']):.4f}", flush=True)
                _check(np.isfinite(objf)
                       and np.isfinite(float(m["grad_norm"])),
                       f"{name}-fed objf_mmi and grad_norm finite")
                _check(after[0] - before[0] == n_timed
                       and after[1] - before[1] == n_timed,
                       f"{name}-fed: each blocked kernel launched once per "
                       "step")
        for name in ("loader", "resident"):
            v = ms[name]
            print(f"[loader] {name}-fed bf16 step: {min(v):.2f}-{max(v):.2f}"
                  f" ms/step ({audio_s / (max(v) / 1e3):.1f}-"
                  f"{audio_s / (min(v) / 1e3):.1f} audio-s/s) over {rounds} "
                  f"rounds of {n_timed} ({gpu})", flush=True)
        holder = [state]

        def profiled(run):
            def go():
                holder[0], m = runs[run](holder[0], n_prof)
                float(m["objf_mmi"])
            return go

        for name in ("loader", "resident"):
            idle = _idle_share(torch, profiled(name))
            print(f"[loader profile] {name}-fed, {n_prof} steps: " + (
                "profiler saw no device kernel" if idle is None else
                f"card idle {idle[0]:.1%} of {idle[2]:.1f} ms "
                f"({idle[1] / n_prof:.1f} ms of kernels a step)")
                  + f" ({gpu})", flush=True)
        state = holder[0]
        launches = {"fwd": bdc.blocked_den_fwd_cuda.launches,
                    "bwd": bdc.blocked_den_bwd_cuda.launches}
        n_steps = 2 * (n_warm + rounds * n_timed + n_prof)
        _check(launches["fwd"] == launches["bwd"] == n_steps,
               "each blocked kernel launched once per step of the phase")

        # ---- 7.2 bit for bit: bf16 against float32 payload, prefetched
        # against synchronous copies ----
        hb = [with_iv(next(host)) for _ in range(4)]
        b16 = list(prefetch_to_device(iter(hb), size=3, device=dev,
                                      payload_bf16=True))
        b32 = list(prefetch_to_device(iter(hb), size=3, device=dev))
        with _deterministic(torch):
            s16, m16 = step(state, b16[0])
            s32, m32 = step(state, b32[0])
            s16b, m16b = step(state, b16[0])
        torch.cuda.synchronize()
        _check(_states_equal(torch, s16, s16b)
               and _metrics_equal(torch, m16, m16b),
               "a deterministic step repeats bit for bit")
        _check(_states_equal(torch, s16, s32)
               and _metrics_equal(torch, m16, m32),
               "bf16-payload step equals the float32-payload step bit for "
               "bit")
        del s16, s32, s16b
        same = 0
        for got16, got32, h in zip(b16, b32, hb):
            for got, want in ((got16, convert.batch_to_torch(
                    compress_batch_bf16(h), dev)),
                              (got32, convert.batch_to_torch(h, dev))):
                ga, wa = _batch_leaves(got), _batch_leaves(want)
                _check(len(ga) == len(wa) and all(
                    a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(ga, wa)),
                    "prefetched batch equals its synchronous copy")
                same += 1
        print(f"[loader bits] bf16-payload step == float32-payload step: "
              f"objf_mmi {float(m16['objf_mmi']):.9g}, all "
              f"{sum(x.numel() for x in _batch_leaves(b16[0]))} batch "
              f"elements; {same} prefetched batches == synchronous copies; "
              f"a deterministic step repeats", flush=True)

        # ---- 7.3 checkpoint round trip: resumed against unbroken ----
        st = init_train_state(model_cfg, trainer_cfg,
                              torch.Generator().manual_seed(0), dev)
        st, _ = resident_fed(st, 2)
        ck = os.path.join(td.name, "ckpt")
        t0 = time.perf_counter()
        path = save_checkpoint(ck, 2, st, meta={
            "model": asdict_config(model_cfg),
            "trainer": asdict_config(trainer_cfg)})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded, ck_step, _ = load_checkpoint(ck, init_train_state(
            model_cfg, trainer_cfg, torch.Generator().manual_seed(5), dev))
        t_load = time.perf_counter() - t0
        _check(ck_step == 2 and _states_equal(torch, loaded, st),
               "the loaded state equals the saved state")
        with _deterministic(torch):
            a, ma = step(loaded, b16[1])
            b, mb = step(st, b16[1])
        torch.cuda.synchronize()
        _check(_states_equal(torch, a, b) and _metrics_equal(torch, ma, mb),
               "resumed step equals the unbroken step bit for bit")
        print(f"[loader ckpt] {os.path.getsize(path + '.npz'):,}-byte .npz "
              f"saved in {t_save:.1f} s, loaded in {t_load:.1f} s; the step "
              f"after it equals the unbroken step leaf for leaf, bit for bit",
              flush=True)
        return launches
    finally:
        if loader is not None:
            loader.close()
        td.cleanup()


def _batch_leaves(batch):
    """The tensors of a batch, in ``convert.map_batch`` order."""
    from tdnnf_nas_torch import convert

    out = []
    convert.map_batch(lambda _, a: out.append(a), batch)
    return out


def _search_phase(torch, dev, gpu, bundle, g, base, batch_size,
                  expect_params):
    """Phase 6, the two-stage DARTS search on the dense biphone den (setup
    of scripts/search_flagship_synthetic.py:48-49,59-92).  ``base`` is the
    searched model's TDNN-F config, ``expect_params`` the two supernets'
    parameter counts.  Returns the dense kernels' launches over the
    search's steps, {"fwd": n, "bwd": n}."""
    import dataclasses
    import tempfile

    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.core.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from tdnnf_nas_torch.core.config import asdict_config
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.models import (BOTTLENECK_DIMS, DartsModelConfig,
                                        SearchMode, count_params,
                                        supernet_context)
    from tdnnf_nas_torch.nas import (arch_param_count, child_config_from_arch,
                                     extract_bottlenecks, extract_offsets)
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)
    from tdnnf_nas_torch.train.optimizer import tree_paths

    chunk_width = 50
    audio_s = batch_size * chunk_width * 3 * 0.010
    launches = {"fwd": 0, "bwd": 0}

    def batches(model_cfg, n, dev_split=False, supernet=True, seed=0):
        chunks = bundle.egs(None if supernet else model_cfg,
                            chunk_width=chunk_width, dev=dev_split,
                            max_phones_per_chunk=40,
                            supernet_cfg=model_cfg if supernet else None)
        out = []
        for b in batch_iterator(chunks, batch_size=batch_size,
                                rng=np.random.RandomState(seed)):
            if len(out) == n:
                break
            out.append(convert.batch_to_torch(b, dev))
        _check(len(out) == n, f"{n} full batches of {batch_size}")
        return len(chunks), out

    def run(label, step, state, bs, n_warm=1):
        """Steps over bs with the launch counters reset before and read
        after; each step launches each dense kernel once.  Prints ms/step
        over the steps after the first n_warm (the first use of each
        kernel and GEMM shape loads and tunes it)."""
        ddc.dense_den_fwd_cuda.launches = 0
        ddc.dense_den_bwd_cuda.launches = 0
        ms = []
        for i, b in enumerate(bs):
            if i == n_warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, b)
            ms.append(m)
            _check(_dense_launches(ddc) == (i + 1, i + 1),
                   f"{label}: one launch of each dense kernel per step")
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (len(bs) - n_warm)
        launches["fwd"] += ddc.dense_den_fwd_cuda.launches
        launches["bwd"] += ddc.dense_den_bwd_cuda.launches
        objfs = [float(m["objf_mmi"]) for m in ms]
        print(f"[{label}] objf_mmi per step: "
              + " ".join(f"{v:.4f}" for v in objfs) + f"; {dt * 1e3:.2f} "
              f"ms/step over {len(bs) - n_warm} steps after {n_warm} "
              f"warm-up, B={batch_size}, T_in={bs[0]['feats'].shape[1]} "
              f"({gpu})",
              flush=True)
        _check(all(np.isfinite(objfs)), f"{label}: objf_mmi finite")
        _check(all(np.isfinite(float(m["grad_norm"])) for m in ms),
               f"{label}: grad_norm finite")
        return state, ms, dt

    # ---- 6.0 setup: the offsets supernet ----
    t0 = time.perf_counter()
    darts = DartsModelConfig(base=base, search_offsets=True, max_stride=6)
    _check(supernet_context(darts) == (85, 85), "context (85, 85)")
    n_train, train_b = batches(darts, 6)
    n_dev, dev_b = batches(darts, 3, dev_split=True, seed=1)
    print(f"[search setup] {time.perf_counter() - t0:.1f} s: context "
          f"{supernet_context(darts)}, {n_train} train / {n_dev} dev chunks, "
          f"feats {list(train_b[0]['feats'].shape)}", flush=True)

    # ---- 6.1 stage A: uniform one-hot pretrain, theta only ----
    pre_cfg = TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=3e-4, num_steps=200),
        search_mode=SearchMode.UNIFORM)
    state = init_train_state(darts, pre_cfg, torch.Generator().manual_seed(0),
                             dev, supernet=True)
    n_params = count_params(state.params)
    shapes = {k: tuple(v.shape) for k, v in state.alphas.items()}
    print(f"[search A] supernet params={n_params:,} alphas={shapes}",
          flush=True)
    _check(n_params == expect_params[0], f"{expect_params[0]:,} params")
    k = darts.num_candidates
    _check(shapes == {"offsets_linear": (darts.num_layers, k),
                      "offsets_affine": (darts.num_layers, k)},
           "offset alphas [L, K] twice")
    step = make_train_step(darts, pre_cfg, g, seed=3, supernet=True)
    torch.cuda.reset_peak_memory_stats(dev)
    state, _, dt_a = run("search A", step, state, train_b, n_warm=2)
    print(f"[search A] bf16, uniform: {audio_s / dt_a:.1f} audio-s/s; peak "
          f"mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"({gpu})", flush=True)

    # ---- 6.2 stage B: gumbel alpha-only cv-update, theta + BN frozen ----
    cv_cfg = TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-2,
                                  lr_final=3e-3, num_steps=60,
                                  alpha_lr_scale=1.0),
        search_mode=SearchMode.GUMBEL, train_theta=False, train_alpha=True,
        bn_frozen=True)
    # the handoff goes through a checkpoint, as the script's
    # (search_flagship_synthetic.py:57-97), which restarts the step count
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        path = save_checkpoint(ck, len(train_b), state, meta={
            "model": asdict_config(darts), "trainer": asdict_config(pre_cfg),
            "supernet": True})
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path + ".npz")
        t0 = time.perf_counter()
        loaded, ck_step, meta = load_checkpoint(ck, init_train_state(
            darts, pre_cfg, torch.Generator().manual_seed(9), dev,
            supernet=True))
        t_load = time.perf_counter() - t0
    _check(ck_step == len(train_b) and meta["supernet"] is True,
           "stage A's checkpoint step and meta")
    _check(_states_equal(torch, loaded, state),
           "the loaded supernet state equals the saved one leaf for leaf")
    print(f"[search handoff] stage A -> checkpoint ({size:,}-byte .npz, "
          f"saved in {t_save:.1f} s, loaded in {t_load:.1f} s) -> stage B; "
          f"loaded state equals the saved one leaf for leaf, bit for bit",
          flush=True)
    state = dataclasses.replace(loaded, step=0)
    del loaded
    before = convert.supernet_state_to_numpy(state)
    step_b = make_train_step(darts, cv_cfg, g, seed=3, supernet=True)
    torch.cuda.reset_peak_memory_stats(dev)
    state, ms_b, _ = run("search B", step_b, state, dev_b)
    after = convert.supernet_state_to_numpy(state)
    for name, i in (("params", 0), ("bn_state", 2)):
        a_leaves = [a for _, a in tree_paths(before[i])]
        b_leaves = [b for _, b in tree_paths(after[i])]
        _check(len(a_leaves) == len(b_leaves) and all(
            np.array_equal(a, b) for a, b in zip(a_leaves, b_leaves)),
            f"stage B leaves {name} unchanged bit for bit")
    moved = max(float(np.abs(after[1][n] - before[1][n]).max())
                for n in before[1])
    _check(moved > 0.0, "stage B moved the alphas")
    print(f"[search B] gumbel, alpha only: tau per step "
          + " ".join(f"{float(m['tau']):.4f}" for m in ms_b)
          + f"; params and BN unchanged bit for bit; max |d alpha| "
          f"{moved:.3e}; peak mem "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB ({gpu})",
          flush=True)

    # ---- 6.3 extraction and the child ----
    archs = extract_offsets(after[1]["offsets_linear"],
                            after[1]["offsets_affine"], top_k=3)
    for rank, (pairs, lp) in enumerate(archs):
        print(f"[search extract] top {rank + 1}: logprob {lp:.4f} "
              f"pairs {list(pairs)}", flush=True)
    _check(len(archs) == 3 and all(
        0 <= s <= darts.max_stride for pr, _ in archs for p in pr for s in p),
        "three archs with offsets in range")
    child = child_config_from_arch(base, stride_pairs=archs[0][0])
    child_tc = TrainerConfig(objective=ChainObjectiveConfig(),
                             optimizer=pre_cfg.optimizer)
    child_state = init_train_state(child, child_tc,
                                   torch.Generator().manual_seed(4), dev)
    n_child = count_params(child_state.params)
    _check(arch_param_count(child) == n_child,
           "arch_param_count(child) == count_params(init_model(child))")
    _, child_b = batches(child, 2, supernet=False)
    run("search child", make_train_step(child, child_tc, g), child_state,
        child_b)
    print(f"[search child] params={n_child:,} = arch_param_count", flush=True)
    del state, step, step_b, train_b, dev_b, child_state, child_b

    # ---- 6.4 the bottleneck supernet ----
    bdarts = DartsModelConfig(base=base, search_offsets=False,
                              fixed_strides=base.stride_pairs,
                              search_bottleneck=True)
    _check(supernet_context(bdarts) == (34, 34), "context (34, 34)")
    n_btrain, btrain_b = batches(bdarts, 2)
    _, bdev_b = batches(bdarts, 2, dev_split=True, seed=1)
    bstate = init_train_state(bdarts, pre_cfg, torch.Generator().manual_seed(6),
                              dev, supernet=True)
    n_bparams = count_params(bstate.params)
    bshape = tuple(bstate.alphas["bottleneck"].shape)
    print(f"[search bottleneck] supernet params={n_bparams:,} alphas "
          f"{bshape}, context {supernet_context(bdarts)}, {n_btrain} train "
          f"chunks", flush=True)
    _check(n_bparams == expect_params[1], f"{expect_params[1]:,} params")
    _check(set(bstate.alphas) == {"bottleneck"} and bshape == (
        bdarts.num_layers, len(bdarts.bottleneck_groups)), "alphas [L, C]")
    bstate, _, _ = run("search bottleneck A", make_train_step(
        bdarts, pre_cfg, g, seed=3, supernet=True), bstate, btrain_b)
    bcv = cv_cfg.replace(flops_coef=1e-4)
    bstate, ms_bb, _ = run("search bottleneck B", make_train_step(
        bdarts, bcv, g, seed=3, supernet=True), bstate, bdev_b)
    eb = [float(m["expected_bottleneck"]) for m in ms_bb]
    dims, _ = extract_bottlenecks(
        bstate.alphas["bottleneck"].cpu().numpy(),
        bdarts.bottleneck_candidates, top_k=1)[0]
    print(f"[search bottleneck] expected_bottleneck per step: "
          + " ".join(f"{v:.2f}" for v in eb) + f"; extracted dims {dims}",
          flush=True)
    _check(all(np.isfinite(eb)), "expected_bottleneck finite")
    _check(len(dims) == bdarts.num_layers
           and all(d in BOTTLENECK_DIMS for d in dims),
           "extracted dims from BOTTLENECK_DIMS")
    del bstate, btrain_b, bdev_b

    # ---- 6.5 a float32 softmax supernet step, kernels vs plain den ----
    f32 = darts.replace(base=base.replace(compute_dtype="float32"))
    sm_cfg = TrainerConfig(objective=ChainObjectiveConfig(),
                           optimizer=pre_cfg.optimizer,
                           search_mode=SearchMode.SOFTMAX, train_alpha=True)
    _, sm_b = batches(f32, 1)
    st0 = init_train_state(f32, sm_cfg, torch.Generator().manual_seed(7), dev,
                           supernet=True)
    step32 = make_train_step(f32, sm_cfg, g, supernet=True)
    _, m_k = step32(copy.deepcopy(st0), sm_b[0])
    n_before = _dense_launches(ddc)
    plain = lambda device: (ddc.dense_scan_fwd_plain,
                            ddc.dense_scan_bwd_plain)
    with mock.patch.object(ddc, "_scan_impl", plain):
        _, m_p = step32(copy.deepcopy(st0), sm_b[0])
    torch.cuda.synchronize()
    _check(_dense_launches(ddc) == n_before,
           "the plain supernet step launched no kernel")
    d_objf = abs(float(m_k["objf_mmi"]) - float(m_p["objf_mmi"]))
    d_gn = abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"]))
    print(f"[search f32 softmax step] objf_mmi kernel="
          f"{float(m_k['objf_mmi']):.9g} plain={float(m_p['objf_mmi']):.9g} "
          f"|d|={d_objf:.2e} (tol 1e-4); grad_norm kernel="
          f"{float(m_k['grad_norm']):.9g} plain="
          f"{float(m_p['grad_norm']):.9g} |d|={d_gn:.2e} (tol 1e-3 "
          f"relative)", flush=True)
    _check(d_objf <= 1e-4, "search f32 objf kernel vs plain")
    _check(d_gn <= 1e-3 * max(float(m_p["grad_norm"]), 1.0),
           "search f32 grad_norm kernel vs plain")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig, batch_iterator,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (accumulate_triphone_stats,
                                        build_clustered_triphone_tree)
    from tdnnf_nas_torch.models import TdnnfModelConfig, count_params
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import cuda_build
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import _MIN_LOG_OBS, BlockedDenGraph
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_name_power()
    print(f"gpu: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 0. build ----
    t0 = time.perf_counter()
    sos = cuda_build.build()
    bdc._library()
    ddc._library()
    print(f"[build] {', '.join(so.name for so in sos)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 1. flagship host setup (bench.py:113-157) ----
    t0 = time.perf_counter()
    batch_size, chunk_width, num_phones = 64, 50, 46
    corpus_cfg = SyntheticCorpusConfig(
        num_utts=768, num_phones=num_phones, feat_dim=40, min_phones=10,
        max_phones=30, mean_dur=4.0, context_shift=1.0, seed=0)
    utts, phone_seqs, _, topo = make_synthetic_corpus(corpus_cfg)
    stats = accumulate_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        num_phones, corpus_cfg.frame_subsampling_factor)
    tree = build_clustered_triphone_tree(stats, num_leaves=6034 - num_phones)
    bundle = prepare_data(utts, phone_seqs, tree, topo, num_phones,
                          phone_lm_order=4, num_extra_lm_states=2000)
    host_den = bundle.den_arrays
    model_cfg = TdnnfModelConfig(num_pdfs=tree.num_pdfs)
    chunks = bundle.egs(model_cfg, chunk_width=chunk_width,
                        max_phones_per_chunk=40)
    iv_rng = np.random.RandomState(3)
    host_batches = []
    for b in batch_iterator(chunks, batch_size=batch_size,
                            rng=np.random.RandomState(0), drop_last=False):
        if len(host_batches) >= 8 or b["feats"].shape[0] != batch_size:
            break
        b["ivectors"] = iv_rng.randn(batch_size, model_cfg.ivector_dim
                                     ).astype(np.float32)
        host_batches.append(b)
    c, nsrc, ndp = host_den.shape
    print(f"[setup] {time.perf_counter() - t0:.1f} s: pdfs={tree.num_pdfs} "
          f"den_states={host_den.num_states} w_blocks=[{c},{nsrc},{ndp}] "
          f"R={host_den.enter_pad} chunks={len(chunks)} "
          f"batches={len(host_batches)} feats="
          f"{list(host_batches[0]['feats'].shape)}", flush=True)
    _check(host_den.num_states == 10271, "10,271 den states")
    _check(tree.num_pdfs == 6034, "6,034 pdfs")
    _check(host_den.bcast_sel is None, "no wildcard term")
    _check(len(host_batches) == 8, "8 full batches")
    g = BlockedDenGraph.from_host(host_den, dev)
    batches = [convert.batch_to_torch(b, dev) for b in host_batches]

    # ---- 2. kernel vs plain at the flagship den shape ----
    # Tolerances: the kernels sum in another order than the plain path's
    # cuBLAS products and torch reductions (no atomics: two kernel runs
    # agree bit for bit).  logZ sums 50 per-frame log-scales of ~1e-6
    # relative error each: |dlogZ| <= 1e-3.  The obs gradient is held
    # relative to its largest entry: 1e-3 in float32; with bf16 obs it is
    # written in bf16, whose rounding step is 2^-8 relative: 1e-2.
    rng = np.random.RandomState(0)
    logits = torch.tensor(rng.randn(batch_size, chunk_width, tree.num_pdfs)
                          .astype(np.float32) * 2.0, device=dev)
    gbar = torch.tensor(rng.rand(batch_size).astype(np.float32) + 0.5,
                        device=dev)
    leaky = 0.1
    errs = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for obs_dtype, grad_rtol in ((torch.float32, 1e-3),
                                 (torch.bfloat16, 1e-2)):
        mx = logits.amax(-1, keepdim=True)
        obs = torch.exp(torch.clamp(logits - mx, min=_MIN_LOG_OBS))
        obs_v = obs.to(obs_dtype).index_select(-1, g.pdf_virtual).contiguous()
        z_k, al_k, cs_k = bdc.blocked_den_fwd_cuda(obs_v, g, leaky)
        gr_k = bdc.blocked_den_bwd_cuda(obs_v, g, al_k, cs_k, gbar)
        z_k2, al_k2, cs_k2 = bdc.blocked_den_fwd_cuda(obs_v, g, leaky)
        gr_k2 = bdc.blocked_den_bwd_cuda(obs_v, g, al_k2, cs_k2, gbar)
        z_p, al_p, cs_p = bdc.blocked_scan_fwd_plain(obs_v, g, leaky)
        gr_p = bdc.blocked_scan_bwd_plain(obs_v, g, al_p, cs_p, gbar)
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(z_k).all() and torch.isfinite(
            gr_k.float()).all()), "finite kernel outputs")
        _check(bool(torch.equal(z_k, z_k2) and torch.equal(gr_k, gr_k2)),
               "kernel runs repeat bit for bit")
        ez = float((z_k - z_p).abs().max())
        eg = float((gr_k.float() - gr_p.float()).abs().max())
        gmax = float(gr_p.float().abs().max())
        ea = float((al_k - al_p).abs().max())
        name = str(obs_dtype).replace("torch.", "")
        print(f"[kernel-vs-plain {name}] logZ max|err|={ez:.3e} (tol 1e-3, "
              f"|logZ|~{float(z_p.abs().mean()):.1f}); alphas "
              f"max|err|={ea:.3e}; grad max|err|={eg:.3e} (tol "
              f"{grad_rtol:g} x max|grad|={gmax:.3e})", flush=True)
        _check(ez <= 1e-3, f"logZ within 1e-3 ({name})")
        _check(eg <= grad_rtol * max(gmax, 1.0), f"grad within tol ({name})")
        errs["fwd"] = max(errs["fwd"], ez)
        errs["bwd"] = max(errs["bwd"], eg)
        if obs_dtype == torch.bfloat16:  # the main path's setting
            times["fwd"] = _cuda_ms(
                torch, lambda: bdc.blocked_den_fwd_cuda(obs_v, g, leaky))
            times["fwd_plain"] = _cuda_ms(
                torch, lambda: bdc.blocked_scan_fwd_plain(obs_v, g, leaky))
            times["bwd"] = _cuda_ms(torch, lambda: bdc.blocked_den_bwd_cuda(
                obs_v, g, al_k, cs_k, gbar))
            times["bwd_plain"] = _cuda_ms(
                torch, lambda: bdc.blocked_scan_bwd_plain(
                    obs_v, g, al_p, cs_p, gbar))
            # yardstick: the scan's block products alone in cuBLAS
            # (float32, TF32 off); bound: 2*B*C*NSRC*NDP flops a product
            # frame against obs, alphas (and grad) and W moved once
            x = torch.rand(c, batch_size, ndp, device=dev)
            y = torch.empty(c, batch_size, ndp, device=dev)
            xs = x[:, :, :nsrc].contiguous()
            ys = torch.empty_like(xs)
            lib = {"fwd": _library_ms(torch, lambda: torch.bmm(
                       xs, g.w_blocks, out=y), chunk_width),
                   "bwd": _library_ms(torch, lambda: torch.bmm(
                       x, g.w_blocks.transpose(1, 2), out=ys), chunk_width)}
            flops = 2.0 * batch_size * c * nsrc * ndp * (chunk_width - 1)
            n_obs = batch_size * chunk_width * c * ndp
            w_bytes = 4.0 * c * nsrc * ndp
            moved = {"fwd": 6.0 * n_obs + w_bytes,
                     "bwd": 8.0 * n_obs + w_bytes}
            bound = {k: _bound(flops, v) for k, v in moved.items()}
            bound_tc = {k: _bound_3xtf32(flops, v) for k, v in moved.items()}
            per_scan = {
                "fwd": _device_launches(
                    torch, lambda: bdc.blocked_den_fwd_cuda(obs_v, g, leaky)),
                "bwd": _device_launches(
                    torch, lambda: bdc.blocked_den_bwd_cuda(
                        obs_v, g, al_k, cs_k, gbar)),
            }
            del x, y, xs, ys
        del al_k, al_k2, al_p, gr_k, gr_k2, gr_p
    print(f"[den timing, bf16 obs, B={batch_size} T={chunk_width} "
          f"V={c * ndp}] fwd kernel {times['fwd']:.3f} ms vs plain "
          f"{times['fwd_plain']:.3f} ms; bwd kernel {times['bwd']:.3f} ms vs "
          f"plain {times['bwd_plain']:.3f} ms ({gpu})", flush=True)
    for k in ("fwd", "bwd"):
        print(f"[den {k}] kernel {times[k]:.3f} ms; cuBLAS products alone "
              f"{lib[k]:.3f} ms; bound {bound[k][0]:.3f} ms ({bound[k][1]}), "
              f"3xTF32 bound {bound_tc[k]:.3f} ms; device launches per scan "
              f"{per_scan[k]} ({gpu})", flush=True)

    # ---- 3. training: the main path ----
    trainer_cfg = TrainerConfig(
        objective=ChainObjectiveConfig(den_obs_bf16=True),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=1e-4, num_steps=100000))
    state = init_train_state(model_cfg, trainer_cfg,
                             torch.Generator().manual_seed(0), dev)
    n_params = count_params(state.params)
    print(f"[model] params={n_params:,} compute_dtype="
          f"{model_cfg.compute_dtype}", flush=True)
    _check(n_params == 18_751_248, "18,751,248 params")
    step = make_train_step(model_cfg, trainer_cfg, g)
    torch.cuda.reset_peak_memory_stats(dev)
    bdc.blocked_den_fwd_cuda.launches = 0
    bdc.blocked_den_bwd_cuda.launches = 0
    objfs = []
    n_warm, n_timed = 2, 6
    for i in range(n_warm):
        state, m = step(state, batches[i])
        objfs.append(float(m["objf_mmi"]))
        _check(bdc.blocked_den_fwd_cuda.launches == i + 1
               and bdc.blocked_den_bwd_cuda.launches == i + 1,
               "one launch of each kernel per step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = []
    for i in range(n_timed):
        state, m = step(state, batches[n_warm + i])
        ms.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_timed
    launches = {"fwd": bdc.blocked_den_fwd_cuda.launches,
                "bwd": bdc.blocked_den_bwd_cuda.launches}
    objfs += [float(m["objf_mmi"]) for m in ms]
    print(f"[train] objf_mmi per step: "
          + " ".join(f"{v:.4f}" for v in objfs), flush=True)
    _check(all(np.isfinite(objfs)), "objf_mmi finite at every step")
    _check(all(np.isfinite(float(m["grad_norm"])) for m in ms),
           "grad_norm finite")
    _check(launches["fwd"] == launches["bwd"] == n_warm + n_timed,
           "both kernels launched once per step")
    held = [state]

    def one_step():
        held[0], _ = step(held[0], batches[0])

    step_kernels = _device_launches(torch, one_step)
    print(f"[train] {dt * 1e3:.2f} ms/step over {n_timed} steps "
          f"(bf16, den_obs_bf16, B={batch_size}x150 frames) = "
          f"{batch_size * chunk_width * 3 * 0.010 / dt:.1f} audio-s/s; "
          f"peak mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"launches fwd={launches['fwd']} bwd={launches['bwd']}; device "
          f"kernel launches per step {step_kernels} (profile) ({gpu})",
          flush=True)
    del held

    # ---- 4. kernel step vs plain step, float32 ----
    # The objective is a mean over 3,200 frames of logZ differences of a
    # few thousand nats; the kernels' logZ error (<= 1e-3) moves it by
    # < 1e-6, and float32 model math (TF32 off) repeats within that.
    f32_cfg = model_cfg.replace(compute_dtype="float32")
    f32_tc = trainer_cfg.replace(objective=ChainObjectiveConfig())
    st0 = init_train_state(f32_cfg, f32_tc,
                           torch.Generator().manual_seed(1), dev)
    step32 = make_train_step(f32_cfg, f32_tc, g)
    _, m_k = step32(copy.deepcopy(st0), batches[0])
    n_before = (bdc.blocked_den_fwd_cuda.launches,
                bdc.blocked_den_bwd_cuda.launches)
    plain = lambda device: (bdc.blocked_scan_fwd_plain,
                            bdc.blocked_scan_bwd_plain)
    with mock.patch.object(bdc, "_scan_impl", plain):
        _, m_p = step32(copy.deepcopy(st0), batches[0])
    torch.cuda.synchronize()
    _check(n_before == (bdc.blocked_den_fwd_cuda.launches,
                        bdc.blocked_den_bwd_cuda.launches),
           "the plain step launched no kernel")
    d_objf = abs(float(m_k["objf_mmi"]) - float(m_p["objf_mmi"]))
    d_gn = abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"]))
    print(f"[f32 step] objf_mmi kernel={float(m_k['objf_mmi']):.9g} "
          f"plain={float(m_p['objf_mmi']):.9g} |d|={d_objf:.2e} (tol 1e-4); "
          f"logz_den kernel={float(m_k['logz_den']):.9g} "
          f"plain={float(m_p['logz_den']):.9g}; "
          f"grad_norm kernel={float(m_k['grad_norm']):.9g} "
          f"plain={float(m_p['grad_norm']):.9g} |d|={d_gn:.2e} "
          f"(tol 1e-3 relative)", flush=True)
    _check(d_objf <= 1e-4, "f32 objf kernel vs plain")
    _check(d_gn <= 1e-3 * max(float(m_p["grad_norm"]), 1.0),
           "f32 grad_norm kernel vs plain")

    del state, st0, step, step32
    resident = batches[0]
    del batches
    dense, dense_bundle, dense_g = _dense_phase(torch, dev, gpu, utts,
                                                phone_seqs, topo, iv_rng)
    search = _search_phase(
        torch, dev, gpu, dense_bundle, dense_g,
        TdnnfModelConfig(num_pdfs=2208, ivector_dim=0), batch_size=32,
        expect_params=(51_494_904, 23_232_504))
    for row, key in zip(dense, ("fwd", "bwd")):
        print(f"[launches] {row['name']}: dense training {row['launches']}, "
              f"search {search[key]}", flush=True)
        row["launches"] += search[key]
    del dense_bundle, dense_g

    # ---- 7. the step fed from a TEGS shard through the native loader ----
    loader_launches = _loader_phase(torch, dev, gpu, chunks, g, model_cfg,
                                    trainer_cfg, resident)
    for k in ("fwd", "bwd"):
        print(f"[launches] blocked_den_{k}: training {launches[k]}, "
              f"loader-fed phase {loader_launches[k]}", flush=True)
        launches[k] += loader_launches[k]

    kernels = [
        {"name": "blocked_den_fwd", "route": "cuda",
         "source": "tdnnf_nas_torch/csrc/blocked_den.cu",
         "replaces": f"{_TPU_KERNELS}:282", "launches": launches["fwd"],
         "max_abs_err": errs["fwd"], "ms": times["fwd"],
         "plain_ms": times["fwd_plain"], "bound_ms": bound["fwd"][0],
         "bound_by": bound["fwd"][1], "library_ms": lib["fwd"],
         "bound_ms_3xtf32": bound_tc["fwd"],
         "launches_per_scan": per_scan["fwd"]},
        {"name": "blocked_den_bwd", "route": "cuda",
         "source": "tdnnf_nas_torch/csrc/blocked_den.cu",
         "replaces": f"{_TPU_KERNELS}:343", "launches": launches["bwd"],
         "max_abs_err": errs["bwd"], "ms": times["bwd"],
         "plain_ms": times["bwd_plain"], "bound_ms": bound["bwd"][0],
         "bound_by": bound["bwd"][1], "library_ms": lib["bwd"],
         "bound_ms_3xtf32": bound_tc["bwd"],
         "launches_per_scan": per_scan["bwd"]},
    ] + dense
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
