#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tdnnf_nas_torch``) on one NVIDIA GPU.

Drives the port's two training paths, a few LF-MMI steps each of the
flagship TDNN-F 7q model (random seeded weights) on 64 x 150-frame
chunks: against the production 4-gram x left-2 triphone blocked
denominator (10,271 states, 6,034 pdfs, 18,751,248 params), and against
the bigram x left-biphone dense denominator (2,208 states, 2,208 pdfs,
16,784,684 params).  Checks the hand-written CUDA kernels of both paths
against their plain PyTorch versions.  Phases, each raising on failure:

  0. build both kernel libraries from ``tdnnf_nas_torch/csrc`` (one nvcc
     per source, started together, sm_90a);
  1. flagship host setup (the ``bench.py`` setup, through the port's own
     numpy host modules): 10,271 den states, 18,751,248 params;
  2. kernel vs plain at the flagship den shape, float32 and bf16 obs,
     with each tolerance and its reason; kernel and plain timings;
  3. training: launch counters reset, then 8 bf16 steps with
     ``den_obs_bf16``; objf finite at every step, both kernels launched
     once per step; ms/step;
  4. one float32 step through the kernels against the same step through
     the plain den, from the same state;
  5. the dense biphone flagship on phase 1's corpus: host setup (2,208
     den states and pdfs, 16,784,684 params); dense-den kernels vs plain
     at B=64, T=50, S=2,208 in float32, with timings; launch counters
     reset, then 6 bf16 steps with the default objective config (objf
     and grad_norm finite, both kernels launched once per step, ms/step);
     one float32 kernel step against the same step through the plain den.

Prints the card's name and power limit, one JSON line of per-kernel
results, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Exits non-zero,
printing no result, without a CUDA device or without the repository.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

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
    gr_k = ddc.dense_den_bwd_cuda(obs, g.trans_T, g.final, al_k, cs_k, gbar)
    z_k2, al_k2, cs_k2 = ddc.dense_den_fwd_cuda(obs, g.trans, g.init,
                                                g.final, leaky)
    gr_k2 = ddc.dense_den_bwd_cuda(obs, g.trans_T, g.final, al_k2, cs_k2,
                                   gbar)
    z_p, al_p, cs_p = ddc.dense_scan_fwd_plain(obs, g.trans, g.init, g.final,
                                               leaky)
    gr_p = ddc.dense_scan_bwd_plain(obs, g.trans_T, g.final, al_p, cs_p, gbar)
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
            obs, g.trans_T, g.final, al_k, cs_k, gbar)),
        "bwd_plain": _cuda_ms(torch, lambda: ddc.dense_scan_bwd_plain(
            obs, g.trans_T, g.final, al_p, cs_p, gbar)),
    }
    print(f"[dense den timing, f32, B={batch_size} T={chunk_width} "
          f"S={g.trans.shape[0]}] fwd kernel {times['fwd']:.3f} ms vs plain "
          f"{times['fwd_plain']:.3f} ms; bwd kernel {times['bwd']:.3f} ms vs "
          f"plain {times['bwd_plain']:.3f} ms ({gpu})", flush=True)
    del al_k, al_k2, al_p, gr_k, gr_k2, gr_p, logits

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
    return [
        {"name": "dense_den_fwd", "route": "cuda", "source": src,
         "replaces": f"{_TPU_KERNELS}:74", "launches": launches["fwd"],
         "max_abs_err": err_z, "ms": times["fwd"],
         "plain_ms": times["fwd_plain"]},
        {"name": "dense_den_bwd", "route": "cuda", "source": src,
         "replaces": f"{_TPU_KERNELS}:110", "launches": launches["bwd"],
         "max_abs_err": err_g, "ms": times["bwd"],
         "plain_ms": times["bwd_plain"]},
    ]


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
        del al_k, al_k2, al_p, gr_k, gr_k2, gr_p
    print(f"[den timing, bf16 obs, B={batch_size} T={chunk_width} "
          f"V={c * ndp}] fwd kernel {times['fwd']:.3f} ms vs plain "
          f"{times['fwd_plain']:.3f} ms; bwd kernel {times['bwd']:.3f} ms vs "
          f"plain {times['bwd_plain']:.3f} ms ({gpu})", flush=True)

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
    print(f"[train] {dt * 1e3:.2f} ms/step over {n_timed} steps "
          f"(bf16, den_obs_bf16, B={batch_size}x150 frames) = "
          f"{batch_size * chunk_width * 3 * 0.010 / dt:.1f} audio-s/s; "
          f"peak mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"launches fwd={launches['fwd']} bwd={launches['bwd']} ({gpu})",
          flush=True)

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

    del state, st0, step, step32, batches, g
    dense = _dense_phase(torch, dev, gpu, utts, phone_seqs, topo, iv_rng)

    kernels = [
        {"name": "blocked_den_fwd", "route": "cuda",
         "source": "tdnnf_nas_torch/csrc/blocked_den.cu",
         "replaces": f"{_TPU_KERNELS}:282", "launches": launches["fwd"],
         "max_abs_err": errs["fwd"], "ms": times["fwd"],
         "plain_ms": times["fwd_plain"]},
        {"name": "blocked_den_bwd", "route": "cuda",
         "source": "tdnnf_nas_torch/csrc/blocked_den.cu",
         "replaces": f"{_TPU_KERNELS}:343", "launches": launches["bwd"],
         "max_abs_err": errs["bwd"], "ms": times["bwd"],
         "plain_ms": times["bwd_plain"]},
    ] + dense
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
