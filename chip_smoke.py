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
den, then the decode path with i-vectors, RNNLM rescoring and LHUC
speaker adaptation, then the tri5_7d path (GMM ladder, +-1 tree,
committed den with its wildcard term), then the front end, the
optimizer kinds and the Bayes/GP and CNN-TDNN-F families, then the
bench-scale +-1 den through the factored scan and data parallel over
two ranks, then the whole flagship run of ``tools/e2e_flagship``, then
the three search experiments (``tools/search_sanity_planted``,
``tools/search_planted_table``, ``tools/e2e_wer_pipeline``), then the
five comparison drivers (``tools/lhuc_regularized``,
``tools/rnnlm_fair_fight``, ``tools/context_compare``,
``tools/wpd_compare``, ``tools/wer_synthetic``).  Checks the
hand-written CUDA kernels of each path
against their plain PyTorch versions.

Before phase 0 the script starts a host worker (``python3 chip_smoke.py
--host-worker DIR``: no card visible, its BLAS, OpenMP and torch threads
capped at ``HOST_WORKER_THREADS``), which builds on the CPU, while the
card runs the earlier phases, phase 12's host set-up and then phase
16's, each handed over as a pickle in DIR (written to a temporary name,
then renamed); the phase that needs one waits for it and prints the
wait, and a worker that exits first fails that phase by name (nothing is
built in its place).  Phases, each raising on failure:

  0. build both kernel libraries from ``tdnnf_nas_torch/csrc`` (one nvcc
     per source, sm_90a) and with g++ the decoders, the loader's copy
     ``csrc/egs_loader.cc`` and the supervision builder
     ``native/egs_builder.cc``, all started together;
  1. flagship host setup (the ``bench.py`` setup, through the port's own
     numpy host modules; the corpus, tree and den built by the host
     worker while phase 0 builds): 10,271 den states, 18,751,248
     params;
  2. kernel vs plain at the flagship den shape, float32 and bf16 obs,
     with each tolerance and its reason, two kernel runs equal bit for
     bit (``_blocked_check``; it prints the plan the library picked for
     the shape, and runs the pair once more with every output and
     scratch buffer between 4 KB sentinel bands that must stay untouched,
     as ``_dense_check`` does for the dense pair at each of its shapes);
     kernel and plain timings, the
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
     kernel and cuBLAS times at the search's B=32 beside them; the same
     checks, times and launches at phase 15's planted sanity den (S =
     16, B = 16, T = 20, built by ``search_sanity_planted.planted_bundle``),
     the shape farthest below one output slice of the kernels' tile
     plan; launch counters reset, then 6 bf16 steps with the default objective config (objf
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
     the .npz size);
  8. the decode path at the flagship's width (``_decode_phase``): the
     smoke word corpus of ``scripts/e2e_flagship.py:70-84`` (46 phones,
     vocab 2,500, 4,000 LM text sentences, lookahead lags, 8 topics) at
     800 utterances, 40 held out, with phase 1's 6,034-pdf left-2 tree;
     i-vectors extracted by the port on the card (``_ivector_stage``,
     ``e2e_flagship.py:172-192`` at its full sizes: a 64-Gaussian UBM,
     6 EM iterations, on every second frame of 150 training utterances;
     a 100-dim T-matrix, 4 iterations, on 600; extraction for all 800;
     within- and between-speaker cosine; each stage's seconds; each
     stage against the CPU on the same inputs); its 4-gram blocked den; 200 bf16
     ``train_model`` steps of the flagship 7q at B = 64 with launch
     counters reset (objf finite, each blocked kernel launched once per
     step); the trigram HCLG (``split_unigram=False``) and the 4-gram of
     ``e2e_flagship.build_graph``; ``forward_corpus`` on the card (ms/utt,
     output frames/s) and, in float32, against the CPU (rtol/atol 1e-4);
     ``decode_corpus_words`` (C++ beam search, beam 16, max_active
     10,000, lattices, 2 forked workers: WER, RTF), the C++ search
     against the numpy one on 3 utterances (words, scores within 1e-3),
     4-gram lattice rescoring (WER) and the lattice oracle; forced
     alignment and the den Viterbi of ``decode_corpus`` on phase 5's
     biphone bundle, each on the card against the CPU;
  9. (``_adapt_rescore_phase``, on phase 8's model, HCLG, trigram and
     lattices) the RNNLM of ``e2e_flagship.py:341-382`` at the reference
     rescorer's width (embed 1024, cell 2048, rpd 512, TDNN splice),
     500 Adam steps at batch 64 on the LM text and training transcripts
     (the reference runs 4,000): ms/step, held-out perplexity on the
     test transcripts, its log-probs on the card against the CPU (1e-4);
     20-best lists (at most 20,000 A* pops each) rescored in batches
     (interpolation 0.5: WER); every
     lattice rescored frontier-batched (WER, s/lattice, device calls),
     and the 3 shortest also by the incremental rescorer (same words,
     scores within 1e-4); then LHUC (``tools/e2e_flagship``, stage 7):
     the blocked pair against its plain version at B = 16 on phase 8's
     den, with phase 2's checks, times and bounds; launch counters
     reset, 24 SGD steps a speaker of the first 8 test utterances at
     B = 16 and the adapted decode
     (WER before and after, ms/step, objf finite at every step, each
     blocked kernel once a step, each speaker's largest adapted logit
     non-zero); one float32 LHUC step on the card (kernels) held to the
     same step in float64 on the CPU (``_lhuc_step_f64``, every op
     checked to compute in float64; 1e-3 of the largest logit), the
     CPU's float32 step held to it at 1e-2;
 10. (``_tri5_7d_phase``) the reference's tri5_7d path on the symmetric
     +-1 corpus of ``scripts/context_compare.py`` (``sym``: 30 phones,
     24-dim features, 720 utterances, 60 held out): e2e stages 1-2
     (``tools/e2e_flagship.bootstrap_stage``) with the SMOKE ladder of
     ``e2e_flagship.py:149-155`` on the card (mono log-likelihood per
     iteration, fmllr_gain, seconds), every phone begin held to the
     port's CPU run of the same ladder (the host worker's; >= 99.9%
     equal, also on the first 40 utterances), then the 400-leaf +-1 tree; the committed trigram
     den (300 extra LM states) with its wildcard term (states, arcs,
     wildcard positions, R, C/NSRC/NDP, seconds); the blocked pair with
     the wildcard against its plain version at B = 64, T = 50 on it
     (``_blocked_check``: phase 2's bars, bit-for-bit repeats, times,
     bounds, cuBLAS yardstick); launch counters reset, 20 bf16 steps of
     the flagship 7q (24-dim input, no i-vectors, B = 64, den_obs_bf16):
     objf finite, each blocked kernel once a step, ms/step and the card's
     idle share over 2 profiled steps;
 11. (``_trainers_phase``, last, on phase 1's blocked den, bundle and
     batches, kept for it) the remaining trainers, model families and
     front end: 64 seeded utterances of 8 kHz audio (2-12 s) written as
     16-bit wavs and read back equal by ``read_wav``; ``featurize_batch``
     (hires MFCC and fbank, speed 0.9 / 1.0 / 1.1, CMVN) on the card
     against the CPU (frame counts equal, features within 1e-2; audio-s/s
     of each); the MFCCs through a compressed ark/scp (within one
     compression step); SpecAugment's masked share against its
     expectation; the ``ng`` (12 steps, recomputes at 0 and 10),
     ``adafactor`` and ``sgd`` + momentum (8 each) optimizer kinds on the
     flagship (bf16, den_obs_bf16, B = 64; launch counters reset per
     kind, objf and grad_norm finite, each blocked kernel once a step,
     ms/step, peak GiB); ``ng``'s update at a recompute step card vs CPU,
     each held to float64; one float32 ``ng`` step through the kernels
     against the plain den; the GP TDNN-F (``gptdnnf-layer``) at the
     flagship's width, 4 steps (chain objective + kl, Adam) and its
     float32 test-mode forward card vs CPU; the CNN-TDNN-F (conv 32 / 32
     / 64, out_dim 1,280) on chunks cut with its context, 4 steps, its
     ConvDARTS variant's gumbel step (the conv_offsets alphas' gradient
     finite and non-zero), and a float32 forward + grad card vs CPU
     against float64;
 12. (``_factored_phase``) the bench-scale +-1 den of
     ``tools/pm1_den_scale.py`` on phase 1's corpus: the 6,034-pdf +-1
     tree, ``prepare_data`` (4-gram LM, 2,000 extra states), whose
     ``to_blocked`` refuses the committed den (the refusal printed) and
     whose factored export takes the arc-list form (no [S, K] table),
     built by the host worker on the corpus it built for phase 1 (so the
     same corpus by construction): states, positions, arcs, K, bytes on
     the card, each host stage's seconds in the worker; the factored
     scan card vs CPU in float32 at B = 2, T = 50 (logZ rtol 1e-5, obs gradient atol 2e-5, two card runs bit for
     bit); 10 bf16 flagship steps through it (objf finite, ms/step, one
     scan's ms, peak GiB, idle share over 2 profiled steps);
     ``forward_score_sparse`` on phase 5's biphone den against the dense
     kernels at B = 64; the native supervision builder on phase 1's
     utterances against the Python builder bit for bit, and the dense
     numerator against the linear one on its graphs (rtol 1e-5);
 13. (``_dp_phase``) data parallel on the one card: two ranks over gloo
     with CUDA tensors (``python3 chip_smoke.py --dp-rank DIR``, started
     through ``parallel.initialize_from_env``; NCCL refuses two ranks on
     one device, so this is the only two-rank check one card allows) on
     32 + 32 rows of phase 1's global batches of 64, the flagship in
     float32 with dropout on phase 1's blocked den, 12 steps each with
     ``sgd`` and ``adam``, against one process at B = 64: the first
     step's objf (rtol 1e-5) and params (atol 5e-4) for both, and for
     ``sgd`` the 12-step trajectory (< 5e-4) and params (atol 5e-4);
     rank 0's witness, one process taking each step on the whole batch
     from a copy of the ranks' state: objf at rtol 1e-5 every step,
     ``sgd``'s params within 5e-4 every step, and for ``adam`` (whose
     trajectory drifts) each step's gradients against a reordering of
     the batch's rows, and its params apart only where the gradient is
     rounding noise; every rank's params equal; each rank launches each
     blocked kernel once a step; then one ``adam`` step of a one-rank
     NCCL group in a process of its own (``python3 chip_smoke.py
     --dp-nccl DIR``, since one run died in it inside this process,
     cause not known; every process of the script has ``faulthandler``
     on, so a fault names its frames);
     ms/step of each;
 14. (``_e2e_phase``) the whole flagship run in this process:
     ``tools/e2e_flagship.main(["all", "--smoke", "--out", TMP])``, the
     reference's nine stages at its smoke sizes with the 7q at full
     width, after checking that phase 13 left no process group, with no
     bootstrap cache; each stage's seconds and the run's WERs and objfs
     beside the reference's full-scale figures (printed, never held);
     checked: the three files' keys, every objf finite, every WER finite
     and >= 0, ``delta_wer`` the difference of the two WERs, the den's
     blocked form, each blocked kernel launched once per training,
     supernet, cv-update, child and LHUC step and the forward once more
     per valid batch (steps counted from the run's metrics), 5 or 6
     table rows of 14 stride pairs with ``manual_baseline`` at stage
     4's parameter count; then one float32 step of the run's model on
     its den through the kernels against the plain scan (objf 1e-4,
     ``grad_norm`` 1e-3 relative).  It runs at ``E2E_CUT``: 4 test
     utterances, 50 RNNLM, 40 no-i-vector and 30 A/B steps, and 40
     supernet, 30 cv-update and 25 child steps, against the smoke
     sizes' 20, 150, 120, 60, 80, 60 and 100;
 15. (``_search_experiments_phase``) the search experiments, each
     tool's ``main`` in this process into a fresh temporary directory:
     (a) ``search_sanity_planted`` on its 16-state dense den at
     ``SANITY_SMOKE_STEPS`` (phase 5 holds the dense pair at this den's
     shape); (b) ``search_planted_table`` on the quick corpus
     (2,227-state blocked den) cut by ``TABLE_SMOKE_CUT`` (steps, and
     20 of the 60 test utterances decoded), then ``_blocked_check`` on
     its den at B = 48, T = 24; (c) ``e2e_wer_pipeline all --variant
     sil`` (the silence-aware HCLG) at ``WER_SMOKE_SIZES``, each cut
     printed beside the reference's figure.  Each run is held to what
     holds at any size: its files' keys are the reference's
     (``docs/``), every objf finite, every WER finite and >= 0,
     ``dev_objf_gap``, ``planted_reach_found`` and ``lookahead_reach``
     their own arithmetic, the cv-update's alphas finite and each
     affine softmax row of the file summing to 1 within its rounding,
     the den's form (dense for (a), blocked for (b) and (c)), each den
     kernel launched once per training, supernet, cv-update and child
     step and the forward once more per valid batch, 1 stride pair a
     row in (a) and 5 in (b) and (c), the manual row's params those of
     the manual config, and one float32 step of the run's model on its
     den through the kernels against the plain scan (objf 1e-4,
     ``grad_norm`` 1e-3 relative); its seconds and the reference's
     figures are printed, never held;
 16. (``_comparison_drivers_phase``) the comparison drivers, each tool's
     ``main`` in this process into a fresh temporary directory: (a)
     ``lhuc_regularized`` and (b) ``rnnlm_fair_fight`` on phase 14's
     set-up with its first ``COMPARE_TEST_UTTS`` test utterances (no
     set-up rebuilt; (a) patches a copy of phase 14's
     ``e2e_flagship.json``); (c) ``context_compare --mode symhard`` and
     (d) ``wpd_compare`` on the host worker's corpora, trees, dens and
     HCLGs; (e) ``wer_synthetic`` at the reference's sizes; each cut
     (``LHUC_SMOKE``, ``FIGHT_SMOKE``, ``CC_SMOKE``, ``WPD_SMOKE``)
     printed beside the reference's figure.  Each run is held to what
     holds at any size: the reference file's keys at every level (table
     rows, variants, sweeps), every objf finite, every WER finite and
     >= 0, ``best_variant`` the first of least ``wer_after`` and the
     patched ``lhuc_noiv`` row its row, ``interp_weight_dev_choice`` the
     dev half's least WER with its eval figure, each contender's den
     blocked with the wildcard term exactly for ``pm1``, (e)'s den
     dense, and each den kernel launched once per training and LHUC step
     and the forward once more per valid batch; then the blocked pair
     against its plain version on (c)'s ``pm1`` den at B = 48, T = 40
     (``_ctx`` keys), the dense pair on (e)'s den at B = 16, T = 20
     (``_ws`` keys), and one float32 step through the kernels against
     the plain scan for (c)'s ``pm1`` contender and for (e);
 17. (``_tools_phase``) the six profile and bench tools, each tool's
     ``run`` in this process into a temporary directory at a cut
     (``TOOLS_ROUNDS`` rounds of ``TOOLS_CALLS`` calls a figure,
     ``TOOLS_STEPS`` timed steps, ``SPARSE_SMOKE``, ``SCALING_SMOKE_RANKS``
     gloo ranks sharing the card): ``profile_components`` (the biphone
     den, S = 2,208), ``profile_den`` and ``bench_triphone_den`` on phase
     1's production set-up (no set-up rebuilt: 10,271 states, 6,034
     pdfs, 18,751,248 params), ``bench_sparse_decode`` on the host (C++
     equal to numpy), ``bench_scaling`` (1 and 2 ranks, each a
     subprocess; no process group left here) and ``bench_dense_den``
     (kernels against the plain scan at 1e-5 in logZ); each prints one
     line of figures, and a failing tool is named.  Its launches join
     every row (the ranks' dense launches with them).

Each phase prints ``[phase N name] start`` before it and ``[phase N
name] ok <s> s`` after it; a failure prints ``[phase N name] FAILED:``
with the exception and its traceback on stdout, then raises.

Prints the card's name and power limit, one JSON line of per-kernel
results (with ``bound_ms``, ``bound_by``, ``library_ms``, the bound of
three TF32 tensor-core passes ``bound_ms_3xtf32``,
``launches_per_scan`` and, for the blocked pair, each of phase 2's
fields again at LHUC's batch with the suffix ``_b16``, on phase 10's
+-1 den with the suffix ``_pm1`` and on phase 15's planted-table den at
B = 48 with the suffix ``_b48`` and on phase 16's ``pm1`` contender den
at B = 48, T = 40 with the suffix ``_ctx``; for the dense pair the B =
32 time, yardstick and bound (``_b32``), phase 5's check at phase 15's
sanity den (S = 16) with the suffix ``_sanity`` and phase 16's on
``wer_synthetic``'s den (B = 16, T = 20) with the suffix ``_ws``; the
blocked rows' launches include phase 11's steps, phase 13's, every
rank's, phase 14's, phase 15's, phase 16's and phase 17's, the dense
rows' phase 15's sanity run, phase 16's ``wer_synthetic`` and phase
17's tools), and as
its last
line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Exits non-zero,
printing no result, without a CUDA device or without the repository.

Usage: python3 chip_smoke.py   (``--dp-rank DIR`` is phase 13's gloo
rank, ``--dp-nccl DIR`` its NCCL rank, ``--host-worker DIR`` the host
worker)
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback
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


# host seconds of idle time around fn() in each profile of
# _device_launches: the first profile holds fn() alone, each later one a
# wider window (late in a run the first profile of a phase has needed up
# to five attempts, and once five were not enough)
_PROFILE_PADS = (0.0, 0.05, 0.25, 0.5, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0)


def _device_launches(torch, fn):
    """Device kernels one fn() call launches (memsets and copies apart),
    read from torch.profiler after a warm-up call; None if no profile
    holds a kernel.  fn() launches at least one kernel, so a profile
    without one lost its events, as profiles of a few milliseconds now
    and then do late in a long run on the card: each retry pads the
    window with host idle time on both sides (``_PROFILE_PADS``), and
    the attempt that saw the kernels is printed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i, pad in enumerate(_PROFILE_PADS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memset", "Memcpy"))
                for e in prof.events())
        if n:
            if i:
                print(f"[profiler] kernels seen on attempt {i + 1} (window "
                      f"padded by {pad} s)", flush=True)
            return n
    return None


# bytes of sentinel on each side of every buffer of a banded launch
_BAND = 4096
_SENTINEL = 0xA5


def _sentinel_bands(torch, dev, specs: dict):
    """{name: (shape, dtype)} -> (views, check): each view lies in an
    allocation of its own between two bands of _BAND bytes filled with
    _SENTINEL; check(what) synchronizes and raises, naming the buffer,
    if any band changed.  A kernel given these views as its outputs and
    scratch shows that it writes nothing past them."""
    views, bufs = {}, {}
    for name, (shape, dtype) in specs.items():
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = torch.full((2 * _BAND + n,), _SENTINEL, dtype=torch.uint8,
                         device=dev)
        views[name] = buf[_BAND:_BAND + n].view(dtype).view(shape)
        bufs[name] = buf

    def check(what: str) -> None:
        torch.cuda.synchronize()
        for name, buf in bufs.items():
            _check(bool((buf[:_BAND] == _SENTINEL).all()
                        and (buf[-_BAND:] == _SENTINEL).all()),
                   f"sentinel bands around {name} intact ({what})")

    return views, check


def _library_ms(torch, mm, t: int) -> float:
    """Device time of a scan's products alone through cuBLAS: t - 1 calls
    of mm(), timed over the whole loop (the yardstick; the port never
    calls it)."""
    return _cuda_ms(torch, lambda: [mm() for _ in range(t - 1)])


def _blocked_check(torch, dev, gpu, g, num_pdfs: int, batch_size: int,
                   t: int = 50):
    """The blocked pair against its plain version on den ``g`` at
    ``batch_size`` x ``t`` frames, float32 and bf16 obs: finite outputs, two
    kernel runs equal bit for bit, logZ and the obs gradient within their
    bars; then, with bf16 obs (the main path's setting), kernel and plain
    times, the scan's block products alone in cuBLAS (``library_ms``),
    both bounds and the device launches of one scan (profiler).  Each
    dtype's pair runs once more with every output and scratch buffer
    between sentinel bands (``_sentinel_bands``), which must stay
    untouched, its outputs equal to the first run's.  Prints the plan the
    library picked for this shape.  Returns {"fwd", "bwd"}: that kernel's
    fields of the ``kernels`` line.

    Tolerances: the kernels sum in another order than the plain path's
    cuBLAS products and torch reductions (no atomics: two kernel runs
    agree bit for bit).  logZ sums t (<= 50) per-frame log-scales of ~1e-6
    relative error each: |dlogZ| <= 1e-3.  The obs gradient is held
    relative to its largest entry: 1e-3 in float32; with bf16 obs it is
    written in bf16, whose rounding step is 2^-8 relative: 1e-2."""
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops.fwdbwd import _MIN_LOG_OBS

    leaky = 0.1
    c, nsrc, ndp = g.w_blocks.shape
    rng = np.random.RandomState(0)
    logits = torch.tensor(rng.randn(batch_size, t, num_pdfs)
                          .astype(np.float32) * 2.0, device=dev)
    gbar = torch.tensor(rng.rand(batch_size).astype(np.float32) + 0.5,
                        device=dev)
    obs = torch.exp(torch.clamp(logits - logits.amax(-1, keepdim=True),
                                min=_MIN_LOG_OBS))
    out = {"fwd": {"max_abs_err": 0.0}, "bwd": {"max_abs_err": 0.0}}
    rw = 0 if g.bcast_sel is None else g.bcast_sel.shape[1]
    for k in out:
        pl = bdc.plan(dev.index or 0, k == "fwd", batch_size, c, nsrc, ndp,
                      g.enter_pad, rw)
        out[k]["plan"] = (f"{pl.tile_rows}-row tiles, {pl.splits} depth "
                          f"splits, rows staged "
                          f"{'by part' if pl.part_staged else 'whole'}, "
                          f"{pl.row_parts} row parts, grid {pl.grid}, W "
                          f"copies {'evict_first' if pl.w_evict_first else 'unhinted'}")
        print(f"[blocked plan {k} B={batch_size} T={t} C={c} NSRC={nsrc} "
              f"NDP={ndp} R={g.enter_pad} RW={rw}] {out[k]['plan']}",
              flush=True)
    for obs_dtype, grad_rtol in ((torch.float32, 1e-3),
                                 (torch.bfloat16, 1e-2)):
        obs_v = obs.to(obs_dtype).index_select(-1, g.pdf_virtual).contiguous()
        z_k, al_k, cs_k = bdc.blocked_den_fwd_cuda(obs_v, g, leaky)
        gr_k = bdc.blocked_den_bwd_cuda(obs_v, g, al_k, cs_k, gbar)
        z_k2, al_k2, cs_k2 = bdc.blocked_den_fwd_cuda(obs_v, g, leaky)
        gr_k2 = bdc.blocked_den_bwd_cuda(obs_v, g, al_k2, cs_k2, gbar)
        z_p, al_p, cs_p = bdc.blocked_scan_fwd_plain(obs_v, g, leaky)
        gr_p = bdc.blocked_scan_bwd_plain(obs_v, g, al_p, cs_p, gbar)
        torch.cuda.synchronize()
        name = (f"{str(obs_dtype).replace('torch.', '')} B={batch_size}"
                + ("" if t == 50 else f" T={t}"))
        _check(bool(torch.isfinite(z_k).all() and torch.isfinite(
            gr_k.float()).all()), f"finite kernel outputs ({name})")
        _check(bool(torch.equal(z_k, z_k2) and torch.equal(gr_k, gr_k2)),
               f"kernel runs repeat bit for bit ({name})")
        ez = float((z_k - z_p).abs().max())
        eg = float((gr_k.float() - gr_p.float()).abs().max())
        gmax = float(gr_p.float().abs().max())
        ea = float((al_k - al_p).abs().max())
        print(f"[kernel-vs-plain {name}] S={g.num_states}: logZ "
              f"max|err|={ez:.3e} (tol 1e-3, |logZ|~"
              f"{float(z_p.abs().mean()):.1f}); alphas max|err|={ea:.3e}; "
              f"grad max|err|={eg:.3e} (tol {grad_rtol:g} x max|grad|="
              f"{gmax:.3e})", flush=True)
        _check(ez <= 1e-3, f"logZ within 1e-3 ({name})")
        _check(eg <= grad_rtol * max(gmax, 1.0), f"grad within tol ({name})")
        for k, e in (("fwd", ez), ("bwd", eg)):
            out[k]["max_abs_err"] = max(out[k]["max_abs_err"], e)
        del al_k2, gr_k2
        f32 = torch.float32
        views, bands = _sentinel_bands(torch, dev, {
            "logz": ((batch_size,), f32), "alphas": (tuple(al_k.shape), f32),
            "cs": (tuple(cs_k.shape), f32),
            "forward scratch": ((bdc.fwd_scratch_floats(obs_v, g),), f32),
            "grad": (tuple(gr_k.shape), obs_dtype),
            "adjoint scratch": ((bdc.bwd_scratch_floats(obs_v, g),), f32)})
        z_b, al_b, cs_b = bdc.blocked_den_fwd_cuda(
            obs_v, g, leaky, out=(views["logz"], views["alphas"],
                                  views["cs"]),
            scratch=views["forward scratch"])
        gr_b = bdc.blocked_den_bwd_cuda(obs_v, g, al_b, cs_b, gbar,
                                        out=views["grad"],
                                        scratch=views["adjoint scratch"])
        bands(f"blocked pair, {name}")
        _check(bool(torch.equal(z_b, z_k) and torch.equal(al_b, al_k)
                    and torch.equal(gr_b, gr_k)),
               f"banded blocked pair equals its first run ({name})")
        print(f"[sentinel bands {name}] blocked pair: {_BAND}-byte bands "
              f"around {len(views)} buffers intact", flush=True)
        del views, z_b, al_b, cs_b, gr_b
    # bf16 obs, the main path's setting, from here on
    run = {"fwd": lambda: bdc.blocked_den_fwd_cuda(obs_v, g, leaky),
           "bwd": lambda: bdc.blocked_den_bwd_cuda(obs_v, g, al_k, cs_k,
                                                   gbar)}
    plain = {"fwd": lambda: bdc.blocked_scan_fwd_plain(obs_v, g, leaky),
             "bwd": lambda: bdc.blocked_scan_bwd_plain(obs_v, g, al_p, cs_p,
                                                       gbar)}
    # yardstick: the scan's block products alone in cuBLAS (float32, TF32
    # off); bound: 2*B*C*NSRC*NDP flops a product frame against obs,
    # alphas (and grad) and W moved once
    x = torch.rand(c, batch_size, ndp, device=dev)
    y = torch.empty(c, batch_size, ndp, device=dev)
    xs = x[:, :, :nsrc].contiguous()
    ys = torch.empty_like(xs)
    mm = {"fwd": lambda: torch.bmm(xs, g.w_blocks, out=y),
          "bwd": lambda: torch.bmm(x, g.w_blocks.transpose(1, 2), out=ys)}
    # a wildcard term adds a rank-R product a frame and its [R, V] rows
    r_w = 0 if g.bcast_sel is None else g.bcast_sel.shape[1]
    flops = 2.0 * batch_size * (c * nsrc * ndp + r_w * c * ndp) * (t - 1)
    n_obs = batch_size * t * c * ndp
    moved = {"fwd": 6.0 * n_obs, "bwd": 8.0 * n_obs}
    for k, o in out.items():
        nbytes = moved[k] + 4.0 * c * nsrc * ndp + 4.0 * r_w * c * ndp
        o["ms"] = _cuda_ms(torch, run[k])
        o["plain_ms"] = _cuda_ms(torch, plain[k])
        o["bound_ms"], o["bound_by"] = _bound(flops, nbytes)
        o["bound_ms_3xtf32"] = _bound_3xtf32(flops, nbytes)
        o["library_ms"] = _library_ms(torch, mm[k], t)
        o["launches_per_scan"] = _device_launches(torch, run[k])
        print(f"[den {k}, bf16 obs, B={batch_size} T={t} V={c * ndp}] "
              f"kernel {o['ms']:.3f} ms vs plain {o['plain_ms']:.3f} ms; "
              f"cuBLAS products alone {o['library_ms']:.3f} ms; bound "
              f"{o['bound_ms']:.3f} ms ({o['bound_by']}, {flops / 1e9:.1f} "
              f"GFLOP), 3xTF32 bound {o['bound_ms_3xtf32']:.3f} ms; device "
              f"launches per scan {o['launches_per_scan']} ({gpu})",
              flush=True)
    return out


def _dense_check(torch, dev, gpu, g, num_pdfs: int, batch_size: int, t: int,
                 half: bool = False):
    """The dense pair against its plain version on den ``g`` at
    ``batch_size`` x ``t`` frames in float32: finite outputs, two kernel
    runs equal bit for bit, logZ within 1e-3 and the log-obs gradient
    within 1e-3 of its largest entry; then kernel and plain times, the
    scan's products alone in cuBLAS (``library_ms``), both bounds and the
    device launches of one scan (one each, checked); the pair once more
    between sentinel bands (``_sentinel_bands``), untouched and equal to
    the first run; with ``half``, the kernel
    and cuBLAS times and the bound again on the first half of the rows
    (keys suffixed ``_b<rows>``).  Returns {"fwd", "bwd"}: each kernel's
    fields.

    Tolerances as in phase 2: the kernels sum in another order than
    cuBLAS and torch (no atomics: runs repeat bit for bit); logZ sums t
    per-frame log-scales of ~1e-6 relative error each: |dlogZ| <= 1e-3;
    the log-obs gradient within 1e-3 of its largest entry."""
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import _MIN_LOG_OBS

    rng = np.random.RandomState(5)
    logits = torch.tensor(rng.randn(batch_size, t, num_pdfs)
                          .astype(np.float32) * 2.0, device=dev)
    obs = torch.clamp(logits - logits.amax(-1, keepdim=True),
                      min=_MIN_LOG_OBS).index_select(-1, g.state_pdf)
    obs = obs.contiguous()
    gbar = torch.tensor(rng.rand(batch_size).astype(np.float32) + 0.5,
                        device=dev)
    leaky = 0.1
    fwd = lambda: ddc.dense_den_fwd_cuda(obs, g.trans, g.init, g.final, leaky)
    z_k, al_k, cs_k = fwd()
    bwd = lambda: ddc.dense_den_bwd_cuda(obs, g.trans, g.final, al_k, cs_k,
                                         gbar)
    gr_k = bwd()
    z_k2, al_k2, _ = fwd()
    gr_k2 = bwd()
    z_p, al_p, cs_p = ddc.dense_scan_fwd_plain(obs, g.trans, g.init, g.final,
                                               leaky)
    gr_p = ddc.dense_scan_bwd_plain(obs, g.trans, g.final, al_p, cs_p, gbar)
    torch.cuda.synchronize()
    name = f"B={batch_size} T={t} S={g.trans.shape[0]}"
    _check(bool(torch.isfinite(z_k).all() and torch.isfinite(gr_k).all()),
           f"finite dense kernel outputs ({name})")
    _check(bool(torch.equal(z_k, z_k2) and torch.equal(al_k, al_k2)
                and torch.equal(gr_k, gr_k2)),
           f"dense kernel runs repeat bit for bit ({name})")
    err = {"fwd": float((z_k - z_p).abs().max()),
           "bwd": float((gr_k - gr_p).abs().max())}
    gmax = float(gr_p.abs().max())
    print(f"[dense kernel-vs-plain f32 {name}] logZ max|err|={err['fwd']:.3e}"
          f" (tol 1e-3); alphas max|err|={float((al_k - al_p).abs().max()):.3e};"
          f" grad max|err|={err['bwd']:.3e} (tol 1e-3 x max|grad|="
          f"{gmax:.3e})", flush=True)
    _check(err["fwd"] <= 1e-3, f"dense logZ within 1e-3 ({name})")
    _check(err["bwd"] <= 1e-3 * max(gmax, 1.0), f"dense grad within tol ({name})")
    f32 = torch.float32
    views, bands = _sentinel_bands(torch, dev, {
        "logz": ((batch_size,), f32), "alphas": (tuple(al_k.shape), f32),
        "cs": (tuple(cs_k.shape), f32),
        "forward scratch": ((ddc.scratch_floats(obs),), f32),
        "grad": (tuple(gr_k.shape), f32),
        "adjoint scratch": ((ddc.scratch_floats(obs),), f32)})
    z_b, al_b, cs_b = ddc.dense_den_fwd_cuda(
        obs, g.trans, g.init, g.final, leaky,
        out=(views["logz"], views["alphas"], views["cs"]),
        scratch=views["forward scratch"])
    gr_b = ddc.dense_den_bwd_cuda(obs, g.trans, g.final, al_b, cs_b, gbar,
                                  out=views["grad"],
                                  scratch=views["adjoint scratch"])
    bands(f"dense pair, {name}")
    _check(bool(torch.equal(z_b, z_k) and torch.equal(al_b, al_k)
                and torch.equal(gr_b, gr_k)),
           f"banded dense pair equals its first run ({name})")
    print(f"[sentinel bands {name}] dense pair: {_BAND}-byte bands around "
          f"{len(views)} buffers intact", flush=True)
    del views, z_b, al_b, cs_b, gr_b
    s = g.trans.shape[0]
    x = torch.rand(batch_size, s, device=dev)
    y = torch.empty_like(x)
    mm = {"fwd": lambda: torch.mm(x, g.trans, out=y),
          "bwd": lambda: torch.mm(x, g.trans.T, out=y)}
    plain = {"fwd": lambda: ddc.dense_scan_fwd_plain(obs, g.trans, g.init,
                                                     g.final, leaky),
             "bwd": lambda: ddc.dense_scan_bwd_plain(obs, g.trans, g.final,
                                                     al_p, cs_p, gbar)}
    # bound: 2*B*S^2 flops a product frame against obs, alphas (and grad)
    # and trans moved once
    flops = 2.0 * batch_size * s * s * (t - 1)
    plane = 4.0 * batch_size * t * s
    out = {}
    for k, run, n_planes in (("fwd", fwd, 2), ("bwd", bwd, 3)):
        o = out[k] = {"max_abs_err": err[k]}
        nbytes = n_planes * plane + 4.0 * s * s
        o["ms"] = _cuda_ms(torch, run)
        o["plain_ms"] = _cuda_ms(torch, plain[k])
        o["bound_ms"], o["bound_by"] = _bound(flops, nbytes)
        o["bound_ms_3xtf32"] = _bound_3xtf32(flops, nbytes)
        o["library_ms"] = _library_ms(torch, mm[k], t)
        o["launches_per_scan"] = _device_launches(torch, run)
        print(f"[dense den {k}, {name}] kernel {o['ms']:.4f} ms vs plain "
              f"{o['plain_ms']:.4f} ms; cuBLAS products alone "
              f"{o['library_ms']:.4f} ms; bound {o['bound_ms']:.6f} ms "
              f"({o['bound_by']}), 3xTF32 bound {o['bound_ms_3xtf32']:.6f} "
              f"ms; device launches per scan {o['launches_per_scan']} "
              f"({gpu})", flush=True)
        _check(o["launches_per_scan"] == 1,
               f"dense {k}: one device kernel per scan ({name})")
    if half:
        h = batch_size // 2
        obs_h, gbar_h = obs[:h].contiguous(), gbar[:h].contiguous()
        _, al_h, cs_h = ddc.dense_den_fwd_cuda(obs_h, g.trans, g.init,
                                               g.final, leaky)
        x_h, y_h = x[:h].contiguous(), y[:h].contiguous()
        run_h = {"fwd": lambda: ddc.dense_den_fwd_cuda(
                     obs_h, g.trans, g.init, g.final, leaky),
                 "bwd": lambda: ddc.dense_den_bwd_cuda(
                     obs_h, g.trans, g.final, al_h, cs_h, gbar_h)}
        mm_h = {"fwd": lambda: torch.mm(x_h, g.trans, out=y_h),
                "bwd": lambda: torch.mm(x_h, g.trans.T, out=y_h)}
        for k, n_planes in (("fwd", 2), ("bwd", 3)):
            o = out[k]
            o[f"ms_b{h}"] = _cuda_ms(torch, run_h[k])
            o[f"library_ms_b{h}"] = _library_ms(torch, mm_h[k], t)
            o[f"bound_ms_b{h}"] = _bound(flops / 2, n_planes * plane / 2
                                         + 4.0 * s * s)[0]
            print(f"[dense den {k}, B={h} T={t} S={s}] kernel "
                  f"{o[f'ms_b{h}']:.4f} ms; cuBLAS products alone "
                  f"{o[f'library_ms_b{h}']:.4f} ms; bound "
                  f"{o[f'bound_ms_b{h}']:.6f} ms ({gpu})", flush=True)
    return out


def _dense_phase(torch, dev, gpu, utts, phone_seqs, topo, iv_rng):
    """Phase 5, the dense biphone flagship; returns its two kernel rows."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.graphs import BiphoneTree
    from tdnnf_nas_torch.models import TdnnfModelConfig, count_params
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    from tdnnf_nas_torch.tools import search_sanity_planted as ssp
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

    # ---- 5.2 kernel vs plain at B=64, T=50, S=2,208, float32, with the
    # kernels and cuBLAS at the search's B=32 (phase 6) beside them ----
    chk = _dense_check(torch, dev, gpu, g, tree.num_pdfs, batch_size,
                       chunk_width, half=True)
    # ---- 5.2b the same at phase 15's sanity den (S = 16, B = 16, T = 20),
    # far below one 192-wide output slice of the kernels' tile plan ----
    p_tree, planted = ssp.planted_bundle()
    _check(planted.den_fsa is None and planted.den.num_states == 16,
           "the planted sanity den: dense, 16 states")
    sanity = _dense_check(torch, dev, gpu,
                          DenGraphArrays.from_graph(planted.den, dev),
                          p_tree.num_pdfs, ssp.BATCH, ssp.CHUNK)

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
    _, m_p = _plain_step(torch, ddc,
                         lambda: step32(copy.deepcopy(st0), batches[0]),
                         "the plain dense step launched no kernel")
    _hold_f32_step(m_k, m_p, "dense f32 step",
                   "dense f32 objf kernel vs plain")

    src = "tdnnf_nas_torch/csrc/dense_den.cu"
    rows = [{"name": f"dense_den_{k}", "route": "cuda", "source": src,
             "replaces": f"{_TPU_KERNELS}:{line}", "launches": launches[k],
             **chk[k],
             "max_abs_err": max(chk[k]["max_abs_err"],
                                sanity[k]["max_abs_err"]),
             **{f"{key}_sanity": v for key, v in sanity[k].items()}}
            for k, line in (("fwd", 74), ("bwd", 110))]
    return rows, bundle, g


def _dense_launches(ddc):
    return (ddc.dense_den_fwd_cuda.launches, ddc.dense_den_bwd_cuda.launches)


def _blocked_launches(bdc):
    return (bdc.blocked_den_fwd_cuda.launches,
            bdc.blocked_den_bwd_cuda.launches)


def _plain_step(torch, mod, run, what: str):
    """run() with the den scans of ``mod`` (the dense or the blocked
    kernels' module) replaced by their plain versions; checks, under the
    name ``what``, that it launched no kernel.  Returns run()'s result."""
    dense = mod.__name__.endswith("dense_den_cuda")
    plain = ((mod.dense_scan_fwd_plain, mod.dense_scan_bwd_plain) if dense
             else (mod.blocked_scan_fwd_plain, mod.blocked_scan_bwd_plain))
    counts = _dense_launches if dense else _blocked_launches
    n0 = counts(mod)
    with mock.patch.object(mod, "_scan_impl", lambda device: plain):
        out = run()
    torch.cuda.synchronize()
    _check(counts(mod) == n0, what)
    return out


def _hold_f32_step(m_k, m_p, tag: str, objf_check: str, head: str = "",
                   mid: str = "", tail: str = ""):
    """Phase 4's bars on one float32 step through the kernels (metrics
    m_k) against the same step through the plain scan (m_p): objf_mmi
    within 1e-4, grad_norm within 1e-3 of max(plain's, 1).  Prints
    ``[tag] head`` with both figures (``mid`` between them, ``tail`` after)
    and checks them as ``objf_check`` and the same name with grad_norm for
    objf.  Returns (|d objf|, |d grad_norm|)."""
    d_objf = abs(float(m_k["objf_mmi"]) - float(m_p["objf_mmi"]))
    d_gn = abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"]))
    print(f"[{tag}] {head}objf_mmi kernel={float(m_k['objf_mmi']):.9g} "
          f"plain={float(m_p['objf_mmi']):.9g} |d|={d_objf:.2e} (tol 1e-4); "
          f"{mid}grad_norm kernel={float(m_k['grad_norm']):.9g} "
          f"plain={float(m_p['grad_norm']):.9g} |d|={d_gn:.2e} "
          f"(tol 1e-3 relative){tail}", flush=True)
    _check(d_objf <= 1e-4, objf_check)
    _check(d_gn <= 1e-3 * max(float(m_p["grad_norm"]), 1.0),
           objf_check.replace("objf", "grad_norm"))
    return d_objf, d_gn


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
    _, m_p = _plain_step(torch, ddc,
                         lambda: step32(copy.deepcopy(st0), sm_b[0]),
                         "the plain supernet step launched no kernel")
    _hold_f32_step(m_k, m_p, "search f32 softmax step",
                   "search f32 objf kernel vs plain")
    return launches


def _rel_ok(a, b, rtol: float, atol: float = 0.0) -> bool:
    """|a - b| <= atol + rtol * |b| everywhere (numpy's allclose rule)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


# Phase 8's sizes: the smoke word corpus of scripts/e2e_flagship.py:70-84
# (vocab 2,500, 4,000 LM text sentences) at 800 utterances, 40 held out.
# Phase 9 searches each 20-best list for at most 20,000 A* pops (the
# reference's 200,000 took ~50 s on lattices with fewer than 20 sequences)
# and adapts the speakers of the first 8 test utterances (20 took 37 s of
# LHUC steps at ~70 ms): phase 14 runs the reference's own n-best and
# LHUC, and the script keeps to its clock on a slow host too.
DECODE_SIZES = dict(num_utts=800, vocab_size=2500, num_text_sents=4000,
                    n_test=40, train_steps=200, n_check=4, n_numpy=3,
                    n_oracle=10, max_active=10000, ubm_utts=150,
                    tmat_utts=600, rnnlm_steps=500, nbest=20,
                    nbest_pops=20000, n_lhuc=8, n_incremental=3)


def _ivector_stage(torch, dev, gpu, utts, train):
    """Phase 8's i-vectors (``scripts/e2e_flagship.py:172-192`` at its
    full sizes): a 64-Gaussian UBM (6 EM iterations) on every second
    frame of 150 training utterances, a 100-dim T-matrix (4 iterations)
    on 600, extraction for all utterances, on the card; each stage
    repeated on the CPU from the card's inputs and held to it.  Returns
    the card's [U, 100] i-vectors."""
    from tdnnf_nas_torch.data.ivector import (IvectorConfig, UbmConfig,
                                              extract_ivectors,
                                              train_ivector_extractor,
                                              train_ubm)

    sz = DECODE_SIZES
    pool = np.concatenate([u.feats for u in train[:sz["ubm_utts"]]])[::2]
    t_feats = [u.feats for u in train[:sz["tmat_utts"]]]
    all_feats = [u.feats for u in utts]
    ucfg = UbmConfig(num_gauss=64, em_iters=6)
    icfg = IvectorConfig(dim=100, em_iters=4)
    secs, card, cpu = {}, {}, {}
    for d, out in ((dev, card), ("cpu", cpu)):
        t0 = time.perf_counter()
        out["ubm"] = train_ubm(pool, ucfg, device=d)
        secs[d, "ubm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # each stage from the card's inputs, so that the CPU repeats it
        out["t"] = train_ivector_extractor(t_feats, card["ubm"], icfg,
                                           device=d)
        secs[d, "t"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["iv"] = extract_ivectors(all_feats, card["ubm"], card["t"],
                                     device=d)
        secs[d, "iv"] = time.perf_counter() - t0
    ivecs = card["iv"]
    spk = np.asarray([u.speaker for u in utts])
    ivn = ivecs / np.linalg.norm(ivecs, axis=1, keepdims=True)
    cos = ivn @ ivn.T
    same = spk[:, None] == spk[None, :]
    off = ~np.eye(len(utts), dtype=bool)
    within, between = float(cos[same & off].mean()), float(cos[~same].mean())
    print(f"[ivector] UBM 64 x 6 EM on {len(pool)} frames "
          f"{secs[dev, 'ubm']:.2f} s, T-matrix 100-dim x 4 EM on "
          f"{len(t_feats)} utts {secs[dev, 't']:.2f} s, extraction of "
          f"{len(utts)} utts {secs[dev, 'iv']:.2f} s on the card (CPU "
          f"{secs['cpu', 'ubm']:.2f} / {secs['cpu', 't']:.2f} / "
          f"{secs['cpu', 'iv']:.2f} s); within-speaker cosine {within:.3f} "
          f"vs between {between:.3f} ({gpu})", flush=True)
    # Card against CPU, TF32 off, each stage from the same inputs.  The
    # posteriors sum ~50k frames and the E-step inverts [100, 100]
    # precisions in float32 in another order on each device: the UBM is
    # held at rtol 1e-3, T at 1e-3 of its largest entry, each i-vector at
    # cosine >= 0.9999 and 1e-3 of its norm.
    ubm_err = "/".join(
        f"{float(np.abs(card['ubm'][k] - cpu['ubm'][k]).max()):.2e}"
        for k in ("means", "vars", "weights"))
    ubm_ok = all(_rel_ok(card["ubm"][k], cpu["ubm"][k], 1e-3, 1e-5)
                 for k in ("means", "vars", "weights"))
    t_err = float(np.abs(card["t"] - cpu["t"]).max()
                  / np.abs(cpu["t"]).max())
    a, b = card["iv"], cpu["iv"]
    iv_cos = float(np.min(np.sum(a * b, 1) / (np.linalg.norm(a, axis=1)
                                               * np.linalg.norm(b, axis=1))))
    iv_err = float(np.max(np.linalg.norm(a - b, axis=1)
                          / np.linalg.norm(b, axis=1)))
    print(f"[ivector check] card vs CPU: UBM max|err| means/vars/weights "
          f"{ubm_err} "
          f"(tol rtol 1e-3 + atol 1e-5); T max err {t_err:.2e} of max|T| "
          f"(tol 1e-3); i-vectors min cosine {iv_cos:.7f} (tol 0.9999), max "
          f"rel err {iv_err:.2e} (tol 1e-3)", flush=True)
    _check(ubm_ok, "UBM on the card equals the CPU's")
    _check(t_err <= 1e-3, "T-matrix on the card equals the CPU's")
    _check(iv_cos >= 0.9999 and iv_err <= 1e-3,
           "i-vectors on the card equal the CPU's")
    _check(np.isfinite(ivecs).all() and ivecs.shape == (len(utts), 100),
           "finite [U, 100] i-vectors")
    return ivecs


def _decode_phase(torch, dev, gpu, tree, topo, dense_bundle):
    """Phase 8, the decode path at the flagship's width: the word corpus
    of scripts/e2e_flagship.py:70-84 (smoke vocabulary) with phase 1's
    6,034-pdf left-2 tree, the 4-gram blocked den, ``train_model`` on the
    flagship 7q (bf16, ``den_obs_bf16``), the trigram HCLG and the 4-gram
    rescoring LM of ``e2e_flagship.build_graph``, ``forward_corpus`` on
    the card (checked against the CPU in float32), the C++ beam search
    with lattices in 2 forked workers (checked against the numpy search),
    4-gram lattice rescoring and the lattice oracle, then the Viterbi
    decoders on the card against the CPU: forced alignment and the phone
    decode on phase 5's biphone bundle.  Returns the blocked kernels'
    launches over the training steps."""
    from tdnnf_nas_torch.core.metrics import MetricsLogger
    from tdnnf_nas_torch.data import native
    from tdnnf_nas_torch.data.synthetic import (WordCorpusConfig,
                                                make_word_corpus)
    from tdnnf_nas_torch.decode.align import align_corpus, align_utterance
    from tdnnf_nas_torch.decode.beam import beam_decode_sparse
    from tdnnf_nas_torch.decode.graph_sparse import build_hclg_sparse
    from tdnnf_nas_torch.decode.lattice import (lattice_oracle_wer,
                                                rescore_lattice)
    from tdnnf_nas_torch.decode.scoring import score_corpus
    from tdnnf_nas_torch.decode.viterbi import graph_log_arrays, viterbi_decode
    from tdnnf_nas_torch.decode.wfst import Lexicon
    from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
    from tdnnf_nas_torch.models import TdnnfModelConfig
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.recipes.chain_recipes import (decode_corpus,
                                                       decode_corpus_words,
                                                       forward_corpus,
                                                       prepare_data,
                                                       train_model)
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state)

    sz = DECODE_SIZES
    t_phase = time.perf_counter()
    # ---- 8.1 host setup through the port's numpy copies ----
    t0 = time.perf_counter()
    cfg = WordCorpusConfig(
        vocab_size=sz["vocab_size"], num_phones=46, feat_dim=40,
        num_utts=sz["num_utts"], min_words=6, max_words=14, min_pron=3,
        max_pron=7, mean_dur=3.5, emission_noise=4.5, context_shift=1.0,
        num_speakers=40, speaker_shift=1.0,
        num_text_sents=sz["num_text_sents"],
        lookahead_lags=(3, 8, 14, 20, 26, 32, 38, 44), lookahead_dim=12,
        lookahead_scale=2.5, num_topics=8, seed=0)
    utts, prons, word_seqs, _, _, _, text = make_word_corpus(cfg)
    n_test = sz["n_test"]
    test, train = utts[:n_test], utts[n_test:]
    t_corpus = time.perf_counter() - t0
    ivecs = list(_ivector_stage(torch, dev, gpu, utts, train))
    iv_test, iv_train = ivecs[:n_test], ivecs[n_test:]
    t0 = time.perf_counter()
    bundle = prepare_data(train, [u.phones for u in train], tree, topo,
                          cfg.num_phones, dev_fraction=0.05,
                          phone_lm_order=4, num_extra_lm_states=2000,
                          ivectors=iv_train)
    t_den = time.perf_counter() - t0
    frames = sum(len(u.pdf_align) for u in utts)
    test_frames = sum(len(u.pdf_align) for u in test)
    test_audio_s = test_frames * 0.03
    print(f"[decode setup] word corpus {len(utts)} utts ({frames} output "
          f"frames, {frames * 0.03 / 3600:.2f} h), vocab {cfg.vocab_size}, "
          f"{len(text)} LM text sentences in {t_corpus:.1f} s; phase 1's "
          f"tree: pdfs={tree.num_pdfs}; 4-gram den: "
          f"states={bundle.den_arrays.num_states} (dense export "
          f"{'kept' if bundle.den is not None else 'none, S > 4,096'}) in "
          f"{t_den:.1f} s; {len(train)} train / {n_test} test utts "
          f"({test_audio_s:.1f} audio-s)", flush=True)
    _check(bundle.den_fsa is not None, "the composed (4-gram) den")

    # ---- 8.2 train the flagship 7q (bf16, den_obs_bf16) ----
    steps = sz["train_steps"]
    mc = TdnnfModelConfig(num_pdfs=tree.num_pdfs)
    tc = TrainerConfig(
        objective=ChainObjectiveConfig(den_obs_bf16=True),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=1e-4, num_steps=steps),
        dropout_schedule=((0.0, 0.0), (0.2, 0.3), (0.5, 0.3), (1.0, 0.0)))
    t0 = time.perf_counter()
    chunks = bundle.egs(mc, chunk_width=50, max_phones_per_chunk=40)
    t_egs = time.perf_counter() - t0
    bdc.blocked_den_fwd_cuda.launches = 0
    bdc.blocked_den_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    state, log = train_model(bundle, mc, tc, steps, batch_size=64,
                             chunk_width=50, seed=0, max_phones_per_chunk=40,
                             metrics=MetricsLogger(), device=dev)
    objf = [v for _, v in log.series["objf_mmi"]]
    t_train = time.perf_counter() - t0
    launches = {"fwd": bdc.blocked_den_fwd_cuda.launches,
                "bwd": bdc.blocked_den_bwd_cuda.launches}
    print(f"[decode train] {len(chunks)} chunks cut in {t_egs:.1f} s; "
          f"{steps} bf16 steps (B=64, chunk 50, den_obs_bf16) in "
          f"{t_train:.1f} s = {t_train / steps * 1e3:.1f} ms/step; objf_mmi "
          f"step 1 {objf[0]:.4f}, {steps // 2} {objf[steps // 2 - 1]:.4f}, "
          f"{steps} {objf[-1]:.4f}; launches fwd={launches['fwd']} "
          f"bwd={launches['bwd']} ({gpu})", flush=True)
    _check(len(objf) == steps and all(np.isfinite(objf)),
           "objf_mmi finite at every decode-phase training step")
    _check(launches["fwd"] == launches["bwd"] == steps,
           "each blocked kernel launched once per training step")

    # ---- 8.3 LMs (e2e_flagship.build_graph) and the trigram HCLG ----
    t0 = time.perf_counter()
    word_sym = [f"w{w}" for w in range(cfg.vocab_size)]
    trans_text = [[word_sym[w] for w in u.words] for u in train]
    full_text = [[word_sym[w] for w in ws] for ws in text] + trans_text
    tg_text = ([[word_sym[w] for w in ws] for ws in text[: len(text) // 10]]
               + trans_text)
    lm3 = estimate_ngram_lm(tg_text, order=3)
    lm4 = estimate_ngram_lm(full_text, order=4)
    t_lm = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_hclg_sparse(Lexicon(prons), lm3, word_sym, topo, tree,
                          split_unigram=False)
    t_hclg = time.perf_counter() - t0
    print(f"[decode graph] LMs: tg {len(lm3.logprobs)} ngrams "
          f"({len(tg_text)} sents), fg {len(lm4.logprobs)} "
          f"({len(full_text)} sents) in {t_lm:.1f} s; HCLG "
          f"{g.num_states} states, {g.num_arcs} arcs in {t_hclg:.1f} s",
          flush=True)

    # ---- 8.4 the forward on the card, and against the CPU in float32 ----
    fwd = lambda d, cfg_, us, ivs, bs=16: forward_corpus(
        None, cfg_, state, us, bucket=64, batch_size=bs, ivectors=ivs,
        device=d)
    t0 = time.perf_counter()
    outs = fwd(dev, mc, test, iv_test)
    t_fwd_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = fwd(dev, mc, test, iv_test)
    t_fwd = time.perf_counter() - t0
    _check(all(o.shape == (len(u.pdf_align), tree.num_pdfs)
               and np.isfinite(o).all() for o, u in zip(outs, test)),
           "forward outputs finite, [T_out, 6034] per utterance")
    # what the forward moves back: float32 [16, T_pad, P] per batch
    pads = {}
    for u in test:
        tp = -(-len(u.pdf_align) // 64) * 64
        pads[tp] = pads.get(tp, 0) + 1
    out_bytes = sum(-(-n // 16) * 16 * tp * tree.num_pdfs * 4
                    for tp, n in pads.items())
    idle = _idle_share(torch, lambda: fwd(dev, mc, test, iv_test))
    print(f"[decode forward] {n_test} utts, B=16, bucket 64, bf16: "
          f"{t_fwd * 1e3 / n_test:.2f} ms/utt, {test_frames / t_fwd:,.0f} "
          f"output frames/s (first call {t_fwd_first * 1e3 / n_test:.2f} "
          f"ms/utt); {len(pads)} buckets, {out_bytes / 1e6:.0f} MB of "
          f"float32 outputs to the host ({out_bytes / t_fwd / 1e9:.1f} GB/s "
          f"over the call); profiled: " + (
              "no device kernel seen" if idle is None else
              f"kernels {idle[1]:.1f} ms, card idle {idle[0]:.1%} of the "
              f"{idle[2]:.1f} ms from first to last kernel") + f" ({gpu})",
          flush=True)
    # float32 on the card (TF32 off) and on the CPU from the same state
    mc32 = mc.replace(compute_dtype="float32")
    n_chk = sz["n_check"]
    chk, iv_chk = test[:n_chk], iv_test[:n_chk]
    card32 = fwd(dev, mc32, chk, iv_chk, bs=n_chk)
    t0 = time.perf_counter()
    cpu32 = fwd("cpu", mc32, chk, iv_chk, bs=n_chk)
    t_cpu = time.perf_counter() - t0
    err = max(float(np.abs(a - b).max()) for a, b in zip(card32, cpu32))
    ok = all(_rel_ok(a, b, 1e-4, 1e-4) for a, b in zip(card32, cpu32))
    print(f"[decode forward check] float32 card vs CPU on {n_chk} utts: "
          f"max|err|={err:.3e} (tol rtol 1e-4 + atol 1e-4, the model "
          f"test's bar); CPU forward {t_cpu:.1f} s", flush=True)
    _check(ok, "card forward equals the CPU forward within 1e-4")

    # ---- 8.5 decode: beam search with lattices, rescoring, oracle ----
    t0 = time.perf_counter()
    native.get_decoder_lib()  # built in phase 0; a build is not decoding
    t_lib = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = decode_corpus_words(None, mc, state, g, test, beam=16.0,
                              max_active=sz["max_active"], lattice=True,
                              lattice_beam=8.0, num_workers=2,
                              ivectors=iv_test, device=dev)
    t_dec = time.perf_counter() - t0
    print(f"[decode words] first-pass (trigram) WER {rep['wer']:.2f}% "
          f"(sub {rep['sub']} ins {rep['ins']} del {rep['del']} of "
          f"{rep['ref_len']}) in {t_dec:.1f} s = RTF "
          f"{t_dec / test_audio_s:.4f} over {test_audio_s:.1f} audio-s "
          f"(beam 16, max_active {sz['max_active']}, lattice beam 8, 2 "
          f"forked workers); forward {t_fwd:.2f} s of it "
          f"({t_fwd / t_dec:.1%}); decoder library ready in {t_lib:.1f} s "
          f"before it ({gpu})", flush=True)
    _check(rep["wer"] < 100.0, "first-pass WER below 100%")
    short = sorted(range(n_test), key=lambda i: len(test[i].pdf_align))
    for i in short[:sz["n_numpy"]]:
        kw = dict(beam=16.0, max_active=sz["max_active"])
        nat = beam_decode_sparse(outs[i], g, **kw)
        t0 = time.perf_counter()
        ref = beam_decode_sparse(outs[i], g, native=False, **kw)
        t_np = time.perf_counter() - t0
        print(f"[decode native vs numpy] utt {i} ({len(outs[i])} frames): "
              f"words equal {nat.words == ref.words}, score "
              f"{nat.score:.4f} vs {ref.score:.4f} (tol 1e-3); numpy "
              f"search {t_np:.1f} s", flush=True)
        _check(nat.words == ref.words and abs(nat.score - ref.score) <= 1e-3,
               "the native decoder equals the numpy decoder")
    refs = [list(u.words) for u in test]
    t0 = time.perf_counter()
    wtt = lambda w: word_sym[w]
    hyps4 = []
    for lat in rep["lattices"]:
        best = rescore_lattice(lat, lm3, lm4, lm_scale=1.0,
                               word_to_token=wtt, n=1)
        hyps4.append(best[0][0] if best else [])
    wer4 = score_corpus(refs, hyps4)["wer"]
    t_resc = time.perf_counter() - t0
    # the oracle walks every arc in Python: a fixed subset of lattices
    t0 = time.perf_counter()
    n_or = sz["n_oracle"]
    oracle = [100.0 * lattice_oracle_wer(lat, r) / max(len(r), 1)
              for lat, r in zip(rep["lattices"][:n_or], refs[:n_or])]
    arcs = [lat.num_arcs for lat in rep["lattices"]]
    print(f"[decode rescore] 4-gram lattice rescoring WER {wer4:.2f}% in "
          f"{t_resc:.1f} s; mean lattice oracle WER {np.mean(oracle):.2f}% "
          f"over the first {len(oracle)} lattices in "
          f"{time.perf_counter() - t0:.1f} s; lattices {min(arcs)}-"
          f"{max(arcs)} arcs (median {int(np.median(arcs))})", flush=True)
    _check(wer4 < 100.0, "4-gram rescored WER below 100%")

    # ---- 8.6 Viterbi on the card against the CPU ----
    t0 = time.perf_counter()
    al = {d: align_corpus(bundle, mc32, state, chk, ivectors=iv_chk,
                          device=d) for d in (dev, "cpu")}
    same = all((a.begins, a.ends) == (b.begins, b.ends)
               for a, b in zip(al[dev], al["cpu"]))
    sc = [[align_utterance(o, u.phones, bundle.lm, topo, tree, device=d)[2]
           for d in (dev, "cpu")] for o, u in zip(card32, chk)]
    print(f"[decode align] {n_chk} utts: begins/ends card == CPU {same}; "
          f"Viterbi scores card vs CPU max rel diff "
          f"{max(abs(a - b) / abs(b) for a, b in sc):.2e} (tol 1e-4) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _check(same, "forced alignment equal on the card and the CPU")
    _check(all(_rel_ok(a, b, 1e-4) for a, b in sc),
           "alignment Viterbi scores within 1e-4 relative")
    t0 = time.perf_counter()
    dcfg = TdnnfModelConfig(num_pdfs=dense_bundle.den.num_pdfs,
                            compute_dtype="float32")
    dstate = init_train_state(dcfg, TrainerConfig(),
                              torch.Generator().manual_seed(8), dev)
    dutts = dense_bundle.dev_utts[:sz["n_check"]]
    per = decode_corpus(dense_bundle, dcfg, dstate, dutts, device=dev)
    douts = forward_corpus(None, dcfg, dstate, dutts, batch_size=len(dutts),
                           device=dev)
    vit = {}
    for d in (dev, "cpu"):
        arrays = graph_log_arrays(dense_bundle.den, d)
        vit[d] = [viterbi_decode(torch.tensor(o[None], device=d), *arrays)
                  for o in douts]
    v_same = all(torch.equal(a[1].cpu(), b[1]) for a, b in zip(vit[dev],
                                                                vit["cpu"]))
    v_sc = [(float(a[0][0]), float(b[0][0]))
            for a, b in zip(vit[dev], vit["cpu"])]
    print(f"[decode phone] decode_corpus on phase 5's biphone bundle "
          f"(den S={dense_bundle.den.num_states}), {len(dutts)} dev utts, "
          f"random weights: PER {per['wer']:.2f}%; Viterbi card vs CPU: "
          f"paths equal {v_same}, max rel score diff "
          f"{max(abs(a - b) / abs(b) for a, b in v_sc):.2e} (tol 1e-4) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _check(v_same and all(_rel_ok(a, b, 1e-4) for a, b in v_sc),
           "den Viterbi on the card equals the CPU's")
    print(f"[decode phase] {time.perf_counter() - t_phase:.1f} s in all, "
          f"{time.perf_counter() - t_phase - t_den:.1f} s without the den "
          f"compile", flush=True)
    ctx = dict(mc=mc, tc=tc, state=state, bundle=bundle, g=g, lm3=lm3,
               word_sym=word_sym, rep=rep, test=test, refs=refs,
               iv_test=iv_test, lm_text=text + word_seqs[n_test:], tree=tree,
               topo=topo)
    return launches, ctx


def _adapt_rescore_phase(torch, dev, gpu, ctx):
    """Phase 9 on phase 8's model, HCLG, trigram and lattices: the RNNLM
    of ``scripts/e2e_flagship.py:341-382`` at the reference rescorer's
    width (embed 1024, cell 2048, rpd 512, TDNN splice; batch 64 on the
    LM text and the training transcripts; DECODE_SIZES' steps, not
    4,000), its log-probs on the card against the CPU, batched n-best
    rescoring (n = 20, interpolation 0.5), frontier-batched lattice
    rescoring of every lattice and the incremental rescorer on the
    shortest, then LHUC (``tools/e2e_flagship.lhuc_adapt_and_decode``,
    stage 7) for the test speakers: the blocked pair against its plain
    version at B = 16, each kernel once per LHUC step, WER before and
    after, and one float32 step on the card against the CPU's through
    the plain den.  Returns (blocked launches, B = 16 errors, times)."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.decode.lattice import (lattice_nbest,
                                                rescore_lattice_rnnlm,
                                                rescore_lattices_rnnlm)
    from tdnnf_nas_torch.decode.rescore import rescore_nbest_rnnlm_batched
    from tdnnf_nas_torch.decode.scoring import score_corpus
    from tdnnf_nas_torch.lm.rnnlm import (RnnLMConfig, RnnLMScorer,
                                          _pad_batch, train_rnnlm)
    from tdnnf_nas_torch.models import count_params
    from tdnnf_nas_torch.models.lhuc import _lhuc_step, init_lhuc
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.tools.e2e_flagship import (LHUC_BATCH,
                                                    lhuc_adapt_and_decode,
                                                    lhuc_batches)
    from tdnnf_nas_torch.data.egs import EgsConfig, make_egs
    from tdnnf_nas_torch.models.tdnnf import model_context
    from tdnnf_nas_torch.train import ChainObjectiveConfig

    sz = DECODE_SIZES
    t_phase = time.perf_counter()
    test, refs, rep = ctx["test"], ctx["refs"], ctx["rep"]
    wtt = lambda w: ctx["word_sym"][w]

    # ---- 9.1 the RNNLM at the reference rescorer's width ----
    rl_cfg = RnnLMConfig(vocab_size=sz["vocab_size"], embed_dim=1024,
                         hidden_dim=2048, proj_dim=512, tdnn_splice=True)
    steps = sz["rnnlm_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, last_ppl = train_rnnlm(ctx["lm_text"], rl_cfg, num_steps=steps,
                                   batch_size=64, seed=0, device=dev)
    torch.cuda.synchronize()
    t_rnn = time.perf_counter() - t0
    scorer = RnnLMScorer(rl_cfg, params)
    inp, tgt = _pad_batch(refs, rl_cfg)
    lp = scorer.token_logprobs(inp, tgt)
    held_ppl = float(torch.exp(-lp.sum() / float((tgt >= 0).sum())))
    n_params = count_params(params)
    print(f"[rnnlm] {n_params:,} params (embed 1024, cell 2048, rpd 512, "
          f"splice), {steps} Adam steps at batch 64 on "
          f"{len(ctx['lm_text'])} sentences in {t_rnn:.1f} s = "
          f"{t_rnn / steps * 1e3:.1f} ms/step (first step's set-up "
          f"included); last batch ppl {last_ppl:.1f}, held-out (the "
          f"{len(refs)} test transcripts) ppl {held_ppl:.1f} ({gpu})",
          flush=True)
    _check(np.isfinite(held_ppl), "finite held-out perplexity")
    # float32 on the card (TF32 off) against the CPU, same weights
    cpu_scorer = RnnLMScorer(rl_cfg, convert.tree_to_device(params, "cpu"))
    err = float((lp.cpu() - cpu_scorer.token_logprobs(inp, tgt)).abs().max())
    print(f"[rnnlm check] token_logprobs card vs CPU on the {len(refs)} "
          f"test transcripts: max|err| {err:.2e} (tol 1e-4)", flush=True)
    _check(err <= 1e-4, "RNNLM log-probs on the card equal the CPU's")

    # ---- 9.2 batched n-best rescoring (e2e_flagship.py:369-375) ----
    t0 = time.perf_counter()
    nbests = [lattice_nbest(lat, n=sz["nbest"], max_pops=sz["nbest_pops"])
              for lat in rep["lattices"]]
    t_nb = time.perf_counter() - t0
    t0 = time.perf_counter()
    bests = rescore_nbest_rnnlm_batched(nbests, ctx["lm3"], scorer,
                                        lm_scale=1.0, interp_weight=0.5,
                                        word_to_token=wtt)
    t_resc = time.perf_counter() - t0
    wer_nb = score_corpus(refs, [b[0] for b in bests])["wer"]
    print(f"[rnnlm n-best] {sum(map(len, nbests))} hypotheses "
          f"({sz['nbest']}-best lists, at most {sz['nbest_pops']:,} pops "
          f"each, in {t_nb:.1f} s) rescored in "
          f"{t_resc:.2f} s, interpolation 0.5: WER {wer_nb:.2f}% "
          f"(first pass {rep['wer']:.2f}%)", flush=True)
    _check(wer_nb < 100.0, "n-best RNNLM WER below 100%")

    # ---- 9.3 frontier-batched lattice rescoring ----
    kw = dict(lm_scale=1.0, word_to_token=wtt, interp_weight=0.5)
    lats = rep["lattices"]
    with mock.patch.object(scorer, "advance_batch",
                           wraps=scorer.advance_batch) as adv:
        t0 = time.perf_counter()
        lat_best = rescore_lattices_rnnlm(lats, ctx["lm3"], scorer, **kw)
        t_lat = time.perf_counter() - t0
        levels = adv.call_count
    wer_lat = score_corpus(refs, [b[0][0] if b else [] for b in lat_best])
    print(f"[rnnlm lattices] {len(lats)} lattices ("
          f"{sum(l.num_arcs for l in lats)} arcs) in {t_lat:.1f} s = "
          f"{t_lat / len(lats):.3f} s/lattice, {levels} device calls "
          f"(levels); WER {wer_lat['wer']:.2f}% ({gpu})", flush=True)
    _check(wer_lat["wer"] < 100.0, "lattice RNNLM WER below 100%")
    short = sorted(range(len(lats)), key=lambda i: lats[i].num_arcs)[
        :sz["n_incremental"]]
    t0 = time.perf_counter()
    batched = rescore_lattices_rnnlm([lats[i] for i in short], ctx["lm3"],
                                     scorer, **kw)
    for i, b in zip(short, batched):
        inc = rescore_lattice_rnnlm(lats[i], ctx["lm3"], scorer, **kw)
        same = [w for w, _ in inc] == [w for w, _ in b]
        d = abs(inc[0][1] - b[0][1])
        print(f"[rnnlm batched vs incremental] lattice {i} "
              f"({lats[i].num_arcs} arcs): words equal {same}, score "
              f"|d| {d:.2e} (tol 1e-4)", flush=True)
        _check(same and d <= 1e-4, "batched rescorer equals incremental")
    print(f"[rnnlm incremental] {len(short)} lattices in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del scorer, cpu_scorer, params

    # ---- 9.4 LHUC: the blocked pair at B = 16, enrollment, decode ----
    mc, state, bundle = ctx["mc"], ctx["state"], ctx["bundle"]
    den = den_on_device(bundle, dev)
    b16 = _blocked_check(torch, dev, gpu, den, mc.num_pdfs, LHUC_BATCH)
    objf, stamps = [], []

    def on_step(m):
        objf.append(float(m["objf_mmi"]))  # syncs: a step per stamp
        stamps.append(time.perf_counter())

    bdc.blocked_den_fwd_cuda.launches = 0
    bdc.blocked_den_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    n_lhuc = sz["n_lhuc"]
    res = lhuc_adapt_and_decode(
        bundle, ctx["topo"], ctx["tree"], ctx["g"], test[:n_lhuc],
        refs[:n_lhuc], ctx["iv_test"][:n_lhuc], ctx["tc"].objective, mc,
        state, True, rep["hyps"][:n_lhuc], on_step=on_step, device=dev)
    t_lhuc = time.perf_counter() - t0
    launches = {"fwd": bdc.blocked_den_fwd_cuda.launches,
                "bwd": bdc.blocked_den_bwd_cuda.launches}
    # step times: gaps between consecutive steps of one speaker (24 each)
    gaps = [b - a for k, (a, b) in enumerate(zip(stamps, stamps[1:]))
            if (k + 1) % 24]
    print(f"[lhuc] {res['speakers']} speakers, {res['utts']} test utts, "
          f"{len(objf)} steps (24 a speaker, B=16, lr 0.2, bf16, "
          f"den_obs_bf16) in {t_lhuc:.1f} s with egs and decode; "
          f"{np.median(gaps) * 1e3:.1f} ms/step (median, "
          f"{min(gaps) * 1e3:.1f}-{max(gaps) * 1e3:.1f}); objf_mmi first "
          f"{objf[0]:.4f}, last {objf[-1]:.4f}; WER {res['wer_before']:.2f}% "
          f"-> {res['wer_after']:.2f}% on the same utterances; launches "
          f"fwd={launches['fwd']} bwd={launches['bwd']} ({gpu})", flush=True)
    _check(len(objf) == 24 * res["speakers"] and all(np.isfinite(objf)),
           "objf_mmi finite at every LHUC step")
    _check(launches["fwd"] == launches["bwd"] == len(objf),
           "each blocked kernel launched once per LHUC step")
    # 2*sigmoid(a) ~ 1 + a/2: a logit a moves its scale by about a/2
    top = res["max_abs_logit"]
    print(f"[lhuc logits] largest |logit| after 24 steps, per speaker: "
          f"min {min(top):.3e}, median {np.median(top):.3e}, max "
          f"{max(top):.3e}; the scales 2*sigmoid(a) move by at most "
          f"{max(top) / 2:.3e}", flush=True)
    _check(len(top) == res["speakers"] and min(top) > 0.0,
           "LHUC moved every speaker's logits off zero")

    # one float32 step on the card (kernels) against the CPU (plain den)
    mc32 = mc.replace(compute_dtype="float32")
    left, right = model_context(mc32)
    spk = test[0].speaker
    idx = [i for i, u in enumerate(bundle.train_utts) if u.speaker == spk]
    chunks = make_egs([bundle.train_utts[i] for i in idx[:10]], bundle.lm,
                      ctx["topo"], ctx["tree"],
                      EgsConfig(chunk_width=50, left_context=left,
                                right_context=right, max_phones_per_chunk=40),
                      den_fsa=bundle.den_fsa,
                      ivectors=[bundle.train_ivectors[i] for i in idx[:10]])
    host = lhuc_batches(chunks)[0]
    obj32 = ChainObjectiveConfig()
    new = {}
    for d in (dev, "cpu"):
        new[d], _ = _lhuc_step(
            mc32, obj32, 0.2, 0.0, convert.tree_to_device(state.params, d),
            convert.tree_to_device(state.bn_state, d), den_on_device(bundle, d),
            init_lhuc(mc32, d), convert.batch_to_torch(host, d))
    exact, narrowed = _lhuc_step_f64(torch, mc32, obj32, state, bundle, host)
    _check(not narrowed and all(v.dtype == np.float64
                                for v in exact.values()),
           f"the float64 LHUC step computed in float64 throughout "
           f"(narrower ops: {dict(narrowed)})")
    a = convert.lhuc_to_numpy(new[dev])
    b = convert.lhuc_to_numpy(new["cpu"])
    err = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    top = max(float(np.abs(b[k]).max()) for k in b)
    # The logits after one step are what is left of the numerator's and
    # the den's gradients after they cancel, so float32 noise is large
    # beside them, and the CPU's float32 step carries most of it (up to
    # 0.63 of the card's bar against float64, the card's 0.19): as phase
    # 11 holds ng's update, both float32 steps are held against the
    # float64 step, the card's at the bar the card-vs-CPU figure had
    # (1e-3 of the largest logit, which that figure missed in 1 of 12
    # runs by the CPU's noise), the CPU's at 10x that bar.
    top64 = max(float(np.abs(v).max()) for v in exact.values())
    errs = {w: max(float(np.abs(x[k] - exact[k]).max()) for k in x)
            for w, x in (("card", a), ("cpu", b))}
    print(f"[lhuc f32 step] B=16, logits against the float64 step on the "
          f"CPU: card (kernels) max|err| {errs['card']:.2e} (tol 1e-3 x "
          f"max, the den gradient's own bar), CPU float32 (plain den) "
          f"{errs['cpu']:.2e} (tol 1e-2 x max), of max|logit| "
          f"{top64:.2e}; card vs CPU {err:.2e} of {top:.2e}", flush=True)
    _check(top64 > 0 and errs["card"] <= 1e-3 * top64,
           "f32 LHUC step on the card equals the float64 step")
    _check(errs["cpu"] <= 1e-2 * top64,
           "f32 LHUC step on the CPU equals the float64 step")
    print(f"[adapt-rescore phase] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, b16


def _lhuc_step_f64(torch, mc32, objective_cfg, state, bundle, host):
    """Phase 9's LHUC step (lr 0.2) in float64 on the CPU, the exact
    reference of its float32 steps: the model computes in float64, the
    den, state and batch are float64 copies, and the port's float32 casts
    (``Tensor.float``) leave float64 tensors as they are.  Returns the new
    logits as numpy and a count, by op, of the step's ops (backward
    included) that made a narrower floating tensor out of a floating input
    of more than one element: none when the step ran in float64 (0-dim
    constants made in float32, such as a log floor, are not counted)."""
    import collections
    import dataclasses

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.models import TdnnfModelConfig
    from tdnnf_nas_torch.models.lhuc import _lhuc_step, init_lhuc
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device

    to_f32 = torch.Tensor.float

    def keep_f64(self, *a, **k):
        return self if self.dtype == torch.float64 else to_f32(self, *a, **k)

    def f64(x):
        return (x.double() if torch.is_tensor(x) and x.is_floating_point()
                else x)

    den = den_on_device(bundle, "cpu")
    den = dataclasses.replace(den, **{
        f.name: f64(getattr(den, f.name)) for f in dataclasses.fields(den)})
    batch = convert.map_batch(lambda _, a: f64(torch.as_tensor(a)), host)

    def floating(tree):
        return [x for x in tree_leaves(tree)
                if torch.is_tensor(x) and x.is_floating_point()]

    class Narrowed(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (any(x.dtype != torch.float64 for x in floating(out))
                    and any(x.numel() > 1
                            for x in floating((args, kwargs)))):
                self.ops[str(func)] += 1
            return out

    args = (_to_f64(state.params), _to_f64(state.bn_state), den,
            _to_f64(init_lhuc(mc32, "cpu")), batch)
    watch = Narrowed()
    with mock.patch.object(torch.Tensor, "float", keep_f64), \
            mock.patch.object(TdnnfModelConfig, "dtype",
                              property(lambda self: torch.float64)), watch:
        new, _ = _lhuc_step(mc32, objective_cfg, 0.2, 0.0, *args)
    return convert.lhuc_to_numpy(new), watch.ops


# scripts/context_compare.py:65-72 with SYM on and HARD off: the symmetric
# +-1 coarticulation corpus of docs/context_compare_sym.json
PM1_CORPUS = dict(vocab_size=300, num_phones=30, feat_dim=24, num_utts=720,
                  min_words=4, max_words=12, min_pron=2, max_pron=5,
                  mean_dur=3.5, emission_noise=1.3, context_shift=0.8,
                  right_context_shift=0.8, num_speakers=8, speaker_shift=1.0,
                  seed=0)
PM1_TEST, PM1_LEAVES, PM1_STEPS = 60, 400, 20


def _tri5_7d_corpus():
    """Phase 10's corpus (context_compare.py's ``sym``): (training
    utterances, their phones, speakers, phone count, topology)."""
    from tdnnf_nas_torch.data.synthetic import (WordCorpusConfig,
                                                make_word_corpus)

    cfg = WordCorpusConfig(**PM1_CORPUS)
    utts, _, _, _, _, topo = make_word_corpus(cfg)[:6]
    train = utts[PM1_TEST:]
    return (train, [u.phones for u in train], [u.speaker for u in train],
            cfg.num_phones, topo)


def _tri5_7d_ladder_config():
    """The SMOKE ladder of e2e_flagship.py:149-155."""
    from tdnnf_nas_torch.gmm import GmmLadderConfig, MonoHmmConfig

    return GmmLadderConfig(
        mono=MonoHmmConfig(num_iters=8, max_mix=2, mix_up_iters=(4,)),
        tri_leaves=120, tri_em_iters=6, splice_context=2, lda_dim=36,
        lda_mllt_em_iters=5, sat_em_iters=4, train_subset=80)


def _tri5_7d_cpu_ladder() -> dict:
    """Phase 10's CPU run of the ladder, built by the host worker:
    {"begins", "fmllr_gain", "seconds_ladder"}."""
    from tdnnf_nas_torch.gmm.ladder import run_gmm_ladder

    train, phones, speakers, n_phones, _ = _tri5_7d_corpus()
    t0 = time.perf_counter()
    cpu = run_gmm_ladder([u.feats for u in train], phones, n_phones,
                         _tri5_7d_ladder_config(), speakers=speakers,
                         device="cpu")
    return {"begins": [list(map(int, b)) for b in cpu.begins],
            "fmllr_gain": float(cpu.fmllr_gain),
            "seconds_ladder": time.perf_counter() - t0}


def _tri5_7d_phase(torch, dev, gpu, host_worker):
    """Phase 10, the reference's tri5_7d path: the GMM ladder on the card
    (held against the port's CPU run, made by the host worker), the
    400-leaf +-1 tree from its alignments, the committed trigram den with
    its wildcard term, the blocked pair against its plain version on it
    (``_blocked_check``), and 20 flagship training steps on it.  Returns
    (the blocked kernels' launches over the training steps, their
    ``_blocked_check`` fields)."""
    import itertools

    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.models import TdnnfModelConfig
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    from tdnnf_nas_torch.tools.e2e_flagship import bootstrap_stage
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)

    t_phase = time.perf_counter()
    train, phones, speakers, n_phones, topo = _tri5_7d_corpus()

    # ---- 10.1 the GMM ladder (e2e_flagship.py:149-155, SMOKE) ----
    cpu = host_worker.take("tri5_7d_cpu_ladder", "phase 10's CPU ladder")
    tree, ladder, secs = bootstrap_stage(
        train, phones, n_phones, _tri5_7d_ladder_config(), PM1_LEAVES,
        tree_kind="pm1", speakers=speakers, frame_subsampling_factor=3,
        device=dev)
    n_ph = sum(len(b) for b in cpu["begins"])
    same = sum(int(x == y) for a, b in zip(ladder.begins, cpu["begins"])
               for x, y in zip(a, b))
    n40 = sum(len(b) for b in cpu["begins"][:40])
    same40 = sum(int(x == y) for a, b in zip(ladder.begins[:40],
                                             cpu["begins"][:40])
                 for x, y in zip(a, b))
    feats = [u.feats for u in train]
    print(f"[tri5_7d gmm] ladder on the card {secs['gmm']:.1f} s (CPU "
          f"{cpu['seconds_ladder']:.1f} s in the host worker), "
          f"{len(train)} utts ({sum(len(f) for f in feats)} "
          f"frames), subset 80: mono loglike per iteration "
          + " ".join(f"{v:.4f}" for v in ladder.mono_ll)
          + f"; fmllr_gain {ladder.fmllr_gain:.4f} (CPU "
          f"{cpu['fmllr_gain']:.4f}); phone begins equal to the CPU run's: "
          f"{same}/{n_ph} ({100.0 * same / n_ph:.3f}%), first 40 utts "
          f"{same40}/{n40} ({gpu})", flush=True)
    _check(same >= 0.999 * n_ph and same40 >= 0.999 * n40,
           "GMM phone begins on the card equal the CPU run's in >= 99.9%")
    _check(all(np.isfinite(ladder.mono_ll)), "finite mono log-likelihoods")

    # ---- 10.2 the +-1 tree and the committed trigram den ----
    t0 = time.perf_counter()
    bundle = prepare_data(train, phones, tree, topo, n_phones,
                          phone_lm_order=3, num_extra_lm_states=300)
    t_den = time.perf_counter() - t0
    host = bundle.den_arrays
    c, nsrc, ndp = host.shape
    r_w = host.bcast_sel.shape[1]
    w_mb = 4.0 * c * nsrc * ndp / 1e6
    print(f"[tri5_7d den] tree {tree.num_pdfs} pdfs in {secs['tree']:.1f} "
          f"s; committed den {bundle.den_fsa.num_states} states, "
          f"{len(bundle.den_fsa.arc_dst)} arcs, "
          f"{len(bundle.den_fsa.wildcard_positions)} wildcard positions, "
          f"R={r_w}, C/NSRC/NDP={c}/{nsrc}/{ndp} (W {w_mb:.1f} MB) in "
          f"{t_den:.1f} s", flush=True)
    _check(bundle.den_fsa.committed and r_w >= 1, "a committed den with a "
           "wildcard term")
    g = BlockedDenGraph.from_host(host, dev)

    # ---- 10.3 the blocked pair with the wildcard vs plain, B=64 T=50 ----
    pm1 = _blocked_check(torch, dev, gpu, g, tree.num_pdfs, 64)
    frames = 49
    print(f"[tri5_7d den] W streamed from device memory every frame: "
          f"{w_mb * frames / 1e3:.2f} GB a scan, "
          f"{w_mb * 1e6 * frames / _PEAK_BYTES * 1e3:.3f} ms at 3.35 TB/s "
          f"(beside the bounds above, which move W once) ({gpu})",
          flush=True)

    # ---- 10.4 20 flagship steps on the committed den ----
    mc = TdnnfModelConfig(num_pdfs=tree.num_pdfs,
                          feat_dim=PM1_CORPUS["feat_dim"],
                          ivector_dim=0)
    tc = TrainerConfig(
        objective=ChainObjectiveConfig(den_obs_bf16=True),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=1e-4, num_steps=100000))
    t0 = time.perf_counter()
    chunks = bundle.egs(mc, chunk_width=50, max_phones_per_chunk=40)
    batches = [convert.batch_to_torch(b, dev) for b in itertools.islice(
        batch_iterator(chunks, batch_size=64, rng=np.random.RandomState(0)),
        PM1_STEPS + 2)]
    t_egs = time.perf_counter() - t0
    state = init_train_state(mc, tc, torch.Generator().manual_seed(0), dev)
    step = make_train_step(mc, tc, g)
    bdc.blocked_den_fwd_cuda.launches = 0
    bdc.blocked_den_bwd_cuda.launches = 0
    objf, times = [], []
    for i in range(PM1_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        objf.append(float(m["objf_mmi"]))
        times.append(time.perf_counter() - t0)
        _check(bdc.blocked_den_fwd_cuda.launches == i + 1
               and bdc.blocked_den_bwd_cuda.launches == i + 1,
               "one launch of each blocked kernel per +-1 step")
    launches = {"fwd": bdc.blocked_den_fwd_cuda.launches,
                "bwd": bdc.blocked_den_bwd_cuda.launches}
    held = [state]

    def two_steps():
        for b in batches[PM1_STEPS:]:
            held[0], _ = step(held[0], b)

    idle = _idle_share(torch, two_steps)
    ms = sorted(t * 1e3 for t in times[2:])
    print(f"[tri5_7d train] {len(chunks)} chunks in {t_egs:.1f} s; "
          f"{PM1_STEPS} bf16 steps (B=64, chunk 50, den_obs_bf16, feat 24, "
          f"no i-vectors): objf_mmi " + " ".join(f"{v:.4f}" for v in objf)
          + f"; after 2 warm-up steps median {ms[len(ms) // 2]:.1f} ms/step "
          f"({ms[0]:.1f}-{ms[-1]:.1f}); launches fwd={launches['fwd']} "
          f"bwd={launches['bwd']}; card idle over 2 profiled steps: "
          + (f"{100 * idle[0]:.1f}% ({idle[1]:.1f} ms of kernels in "
             f"{idle[2]:.1f} ms)" if idle else "no device event recorded")
          + f" ({gpu})", flush=True)
    _check(all(np.isfinite(objf)), "objf_mmi finite at every +-1 step")
    _check(launches["fwd"] == launches["bwd"] == PM1_STEPS,
           "each blocked kernel launched once per +-1 step")
    print(f"[tri5_7d phase] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, pm1


# phase 1's batch and output frames per chunk (150 input frames)
FLAGSHIP_BATCH, FLAGSHIP_CHUNK = 64, 50


def _flagship_corpus():
    """The flagship corpus (bench.py:113-120) from its seed: (utts,
    phone_seqs, topo); phase 1 and the host worker each build it."""
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)

    corpus_cfg = SyntheticCorpusConfig(
        num_utts=768, num_phones=46, feat_dim=40, min_phones=10,
        max_phones=30, mean_dur=4.0, context_shift=1.0, seed=0)
    utts, phone_seqs, _, topo = make_synthetic_corpus(corpus_cfg)
    return utts, phone_seqs, topo


def _flagship_host_setup() -> dict:
    """Phase 1's host set-up (bench.py:113-129) through the port's numpy
    host modules, built by the host worker: the flagship corpus, the
    6,034-pdf left-2 tree and ``prepare_data``'s 4-gram blocked den
    ({"utts", "phone_seqs", "topo", "tree", "bundle", "tree_seconds": the
    statistics' and the clustering's})."""
    from tdnnf_nas_torch.graphs import (accumulate_triphone_stats,
                                        build_clustered_triphone_tree)
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data

    num_phones = 46
    utts, phone_seqs, topo = _flagship_corpus()
    t0 = time.perf_counter()
    stats = accumulate_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        num_phones, 3)
    tree = build_clustered_triphone_tree(stats, num_leaves=6034 - num_phones)
    t_tree = time.perf_counter() - t0
    bundle = prepare_data(utts, phone_seqs, tree, topo, num_phones,
                          phone_lm_order=4, num_extra_lm_states=2000)
    return {"utts": utts, "phone_seqs": phone_seqs, "topo": topo,
            "tree": tree, "bundle": bundle, "tree_seconds": t_tree}


def _flagship_setup(dev, host_worker):
    """Phase 1, the flagship set-up (bench.py:113-157) on the host
    worker's corpus, tree and den (``_flagship_host_setup``): (utts,
    phone_seqs, topo, tree, bundle, model_cfg, chunks, iv_rng,
    host_batches, blocked den on ``dev``)."""
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.models import TdnnfModelConfig
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    t0 = time.perf_counter()
    built = host_worker.take("flagship", "phase 1's corpus, tree and den")
    utts, phone_seqs, topo, tree, bundle = (
        built[k] for k in ("utts", "phone_seqs", "topo", "tree", "bundle"))
    host_den = bundle.den_arrays
    model_cfg = TdnnfModelConfig(num_pdfs=tree.num_pdfs)
    chunks = bundle.egs(model_cfg, chunk_width=FLAGSHIP_CHUNK,
                        max_phones_per_chunk=40)
    iv_rng = np.random.RandomState(3)
    host_batches = []
    for b in batch_iterator(chunks, batch_size=FLAGSHIP_BATCH,
                            rng=np.random.RandomState(0), drop_last=False):
        if len(host_batches) >= 8 or b["feats"].shape[0] != FLAGSHIP_BATCH:
            break
        b["ivectors"] = iv_rng.randn(FLAGSHIP_BATCH, model_cfg.ivector_dim
                                     ).astype(np.float32)
        host_batches.append(b)
    c, nsrc, ndp = host_den.shape
    print(f"[setup] {time.perf_counter() - t0:.1f} s here, "
          f"{built['seconds']:.1f} s in the host worker (tree "
          f"{built['tree_seconds']:.1f} s): "
          f"pdfs={tree.num_pdfs} "
          f"den_states={host_den.num_states} w_blocks=[{c},{nsrc},{ndp}] "
          f"R={host_den.enter_pad} chunks={len(chunks)} "
          f"batches={len(host_batches)} feats="
          f"{list(host_batches[0]['feats'].shape)}", flush=True)
    _check(host_den.num_states == 10271, "10,271 den states")
    _check(tree.num_pdfs == 6034, "6,034 pdfs")
    _check(host_den.bcast_sel is None, "no wildcard term")
    _check(len(host_batches) == 8, "8 full batches")
    return (utts, phone_seqs, topo, tree, bundle, model_cfg, chunks, iv_rng,
            host_batches, BlockedDenGraph.from_host(host_den, dev))



# Phase 11a's audio: 64 utterances of 8 kHz audio, 2-12 s (the length
# spread of Switchboard segments), made from a seed
FRONTEND_UTTS, FRONTEND_RATE = 64, 8000


def _synthetic_audio(n_utts: int, seed: int):
    """int16-range float32 waveforms: two or three tones under syllable-
    rate envelopes, plus noise."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_utts):
        n = int(rng.uniform(2.0, 12.0) * FRONTEND_RATE)
        t = np.arange(n) / FRONTEND_RATE
        x = np.zeros(n)
        for _ in range(rng.randint(2, 4)):
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 6) * t
                                     + rng.uniform(0, 2 * np.pi))
            x += (rng.uniform(1000, 5000) * env
                  * np.sin(2 * np.pi * rng.uniform(100, 3500) * t))
        x += rng.randn(n) * rng.uniform(50, 400)
        out.append(np.clip(np.round(x), -32768, 32767).astype(np.float32))
    return out


def _specaug_expected_share(t: int, f: int, cfg) -> float:
    """E[masked share] of spec_augment on a [T, F] map: a position stays
    with probability q^M per axis, q the chance that one mask (width
    uniform in [0, W], start uniform in [0, max(size - width, 1))) misses
    it; the axes are independent."""
    def keep(size, width_max, n_masks):
        miss = np.zeros(size)
        for w in range(width_max + 1):
            hi = max(size - w, 1)
            hit = np.zeros(size + 1)
            np.add.at(hit, np.arange(hi), 1.0)      # mask start
            np.add.at(hit, np.minimum(np.arange(hi) + w, size), -1.0)
            miss += 1.0 - np.cumsum(hit)[:size] / hi
        return np.mean((miss / (width_max + 1)) ** n_masks)

    return 1.0 - (keep(t, cfg.time_mask_width, cfg.num_time_masks)
                  * keep(f, cfg.freq_mask_width, cfg.num_freq_masks))


def _frontend_stage(torch, dev, gpu):
    """11a: wavs -> read_wav -> featurize_batch (MFCC and fbank, speed
    0.9 / 1.0 / 1.1, CMVN) on the card against the CPU, a compressed
    ark/scp round trip, SpecAugment's masked share."""
    import tempfile
    import wave

    from tdnnf_nas_torch.data import kaldi_io
    from tdnnf_nas_torch.data.audio import featurize_batch, read_wav
    from tdnnf_nas_torch.frontend import FbankConfig, MfccConfig
    from tdnnf_nas_torch.frontend.specaug import (SpecAugmentConfig,
                                                  spec_augment)

    wavs = _synthetic_audio(FRONTEND_UTTS, seed=11)
    audio_s = sum(len(w) for w in wavs) / FRONTEND_RATE
    with tempfile.TemporaryDirectory() as tmp:
        read = []
        for i, w in enumerate(wavs):
            path = os.path.join(tmp, f"utt{i:03d}.wav")
            with wave.open(path, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(FRONTEND_RATE)
                f.writeframes(w.astype("<i2").tobytes())
            x, sr = read_wav(path)
            _check(sr == FRONTEND_RATE and np.array_equal(x, w),
                   "read_wav gives the written samples")
            read.append(x)
    print(f"[frontend] {len(wavs)} wavs, {audio_s:.1f} audio-s "
          f"({min(len(w) for w in wavs) / FRONTEND_RATE:.2f}-"
          f"{max(len(w) for w in wavs) / FRONTEND_RATE:.2f} s), written "
          f"as 16-bit wav and read back equal", flush=True)
    # card vs CPU, no dither: cuFFT against pocketfft and the mel and DCT
    # products in another order (matmul TF32 off) round differently in
    # float32.  An FFT's rounding error scales with the frame's whole
    # power, so a quiet mel band of a loud frame (tones 1e5-1e6 times its
    # noise floor) carries a relative error of ~1e-4 and its log as much
    # absolute, which the lifted DCT sums over 40 bands; the features
    # span ~30 (fbank) to ~200 (MFCC c0): 1e-2 absolute on every valid
    # frame (1.46e-3 seen on the card)
    bar = 1e-2
    mfcc_feats = None
    for name, cfg, mfcc in (("mfcc", MfccConfig(), True),
                            ("fbank", FbankConfig(), False)):
        for speed in (0.9, 1.0, 1.1):
            run = lambda device: featurize_batch(
                read, cfg, mfcc=mfcc, speed_factor=speed, device=device)
            run(dev)  # warm-up (cuFFT plans)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats, counts = run(dev)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref, ref_counts = run("cpu")
            t_cpu = time.perf_counter() - t0
            _check(counts == ref_counts, f"{name} x{speed}: frame counts "
                   "card == CPU")
            got = feats.cpu()
            err = max(float((got[i, :c] - ref[i, :c]).abs().max())
                      for i, c in enumerate(counts))
            s_in = audio_s / speed
            print(f"[frontend] {name} speed {speed}: feats "
                  f"{list(feats.shape)}, {sum(counts)} frames; card "
                  f"{t_card * 1e3:.2f} ms = {s_in / t_card:.0f} audio-s/s, "
                  f"CPU {t_cpu * 1e3:.1f} ms = {s_in / t_cpu:.0f} audio-s/s; "
                  f"card vs CPU max|d| {err:.2e} (bar {bar:g}) ({gpu})",
                  flush=True)
            _check(bool(torch.isfinite(got).all()), f"{name} finite")
            _check(err <= bar, f"{name} x{speed} card vs CPU")
            if mfcc and speed == 1.0:
                mfcc_feats, mfcc_counts = got, counts
    # the MFCCs as a compressed ark/scp, read back through the scp
    with tempfile.TemporaryDirectory() as tmp:
        ark, scp = os.path.join(tmp, "feats.ark"), os.path.join(tmp,
                                                                "feats.scp")
        items = [(f"utt{i:03d}", mfcc_feats[i, :c].numpy())
                 for i, c in enumerate(mfcc_counts)]
        kaldi_io.write_ark(ark, items, scp_path=scp, compress=True)
        size = os.path.getsize(ark)
        entries = kaldi_io.read_scp(scp)
        _check([e[0] for e in entries] == [k for k, _ in items],
               "scp keys in order")
        worst = 0.0
        glob = max(float(m.max()) for _, m in items) - min(
            float(m.min()) for _, m in items)
        for (key, mat), entry in zip(items, entries):
            back = kaldi_io.load_scp_matrix(entry)
            col = mat.max(0) - mat.min(0)
            # one uint8 step is at most a 63rd of a column's range, plus
            # the headers' 16-bit quantization of the global range
            step = col / 63.0 + glob / 65535.0
            worst = max(worst, float((np.abs(back - mat) / step).max()))
        f32_bytes = 4 * sum(m.size for _, m in items)
        print(f"[frontend] compressed ark: {len(items)} matrices, "
              f"{size / 2**20:.2f} MiB ({size / f32_bytes:.3f} of float32);"
              f" worst error {worst:.3f} of one compression step (bar 1)",
              flush=True)
        _check(worst <= 1.0, "CM round trip within one compression step")
    # SpecAugment on the card: the masked share over 16 draws of the
    # batch against the config's expectation
    sa = SpecAugmentConfig()
    x = torch.ones_like(mfcc_feats.to(dev))
    gen = torch.Generator(dev).manual_seed(5)
    shares = [float((spec_augment(x, sa, gen) == sa.mask_value).float()
                    .mean()) for _ in range(16)]
    want = _specaug_expected_share(x.shape[1], x.shape[2], sa)
    got = float(np.mean(shares))
    print(f"[frontend] spec_augment on {list(x.shape)}: masked share "
          f"{got:.4f} over 16 draws, expected {want:.4f} (margin 0.02)",
          flush=True)
    _check(abs(got - want) <= 0.02, "spec_augment masked share")


def _timed_steps(torch, step_fn, n: int):
    """Run step_fn(i) n times, synchronizing after each: (outputs, ms)."""
    outs, ms = [], []
    for i in range(n):
        t0 = time.perf_counter()
        outs.append(step_fn(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _reset_blocked(bdc):
    bdc.blocked_den_fwd_cuda.launches = 0
    bdc.blocked_den_bwd_cuda.launches = 0


def _check_launches(bdc, n: int, what: str):
    _check(_blocked_launches(bdc) == (n, n),
           f"{what}: each blocked kernel launched once per step")


def _optimizer_stage(torch, dev, gpu, g, model_cfg, batches):
    """11b: the ng, adafactor and sgd + momentum kinds on the flagship
    (bf16, den_obs_bf16, B = 64); ng's update on the card against the
    CPU at a recompute step; one float32 ng step through the kernels
    against the plain den.  Returns the blocked launches of the steps."""
    from tdnnf_nas_torch.models import tdnnf as tdnnf_mod
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)
    from tdnnf_nas_torch.train.objective import chain_objective
    from tdnnf_nas_torch.train.optimizer import (make_optimizer, tree_get,
                                                 tree_paths, tree_unflatten)
    from tdnnf_nas_torch.train.trainer import _wd_scale

    total = 0
    base = dict(lr_initial=1e-3, lr_final=1e-4, num_steps=100000)
    for kind, n_steps, extra in (("ng", 12, dict(ng_update_period=10)),
                                 ("adafactor", 8, {}),
                                 ("sgd", 8, dict(momentum=0.9))):
        tc = TrainerConfig(objective=ChainObjectiveConfig(den_obs_bf16=True),
                           optimizer=OptimizerConfig(kind=kind, **base,
                                                     **extra))
        state = [init_train_state(model_cfg, tc,
                                  torch.Generator().manual_seed(0), dev)]
        step = make_train_step(model_cfg, tc, g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_blocked(bdc)

        def one(i):
            state[0], m = step(state[0], batches[i % len(batches)])
            return float(m["objf_mmi"]), float(m["grad_norm"])

        out, ms = _timed_steps(torch, one, n_steps)
        _check_launches(bdc, n_steps, kind)
        total += n_steps
        _check(all(np.isfinite(v) for o in out for v in o),
               f"{kind}: objf_mmi and grad_norm finite at every step")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if kind == "ng":
            rec = [i for i in range(n_steps) if i % 10 == 0]
            rest = [ms[i] for i in range(n_steps) if i % 10]
            rec_ms = ", ".join(f"{i}: {ms[i]:.1f}" for i in rec)
            times = (f"recompute steps {rec_ms} ms, the other {len(rest)} "
                     f"{np.mean(rest):.2f} ms/step ({min(rest):.2f}-"
                     f"{max(rest):.2f})")
        else:
            times = (f"{np.mean(ms[1:]):.2f} ms/step after the first "
                     f"({ms[0]:.1f} ms)")
        print(f"[optimizer {kind}] {n_steps} steps: objf_mmi "
              + " ".join(f"{o[0]:.4f}" for o in out)
              + f"; {times}; peak mem {peak:.2f} GiB; launches "
              f"{_blocked_launches(bdc)} ({gpu})", flush=True)
        del state, step

    # ng's update alone at a recompute step: card vs CPU on the flagship's
    # float32 gradients (TF32 off)
    f32_cfg = model_cfg.replace(compute_dtype="float32")
    ocfg = OptimizerConfig(kind="ng", **base)
    tc = TrainerConfig(objective=ChainObjectiveConfig(), optimizer=ocfg)
    st = init_train_state(f32_cfg, tc, torch.Generator().manual_seed(1), dev)
    # every layer gets a gradient only once the zero-initialized output
    # heads are not zero
    st = dataclasses.replace(st, params=_random_heads(torch, st.params, 8))
    pl = tree_paths(st.params)
    leaves = [x.detach().requires_grad_(True) for _, x in pl]
    params = tree_unflatten([(p, x) for (p, _), x in zip(pl, leaves)])
    b = batches[0]
    chain, xent, _ = tdnnf_mod.apply_model(f32_cfg, params, st.bn_state,
                                           b["feats"], b.get("ivectors"),
                                           train=True)
    loss, _ = chain_objective(chain, xent, g, b["sup"], tc.objective)
    grads = [x.detach() for x in torch.autograd.grad(loss, leaves)]
    _, update = make_optimizer(ocfg, _wd_scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_p, new_s = update(grads, st.opt_state, st.params, 0)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_p, ref_s = update([x.cpu() for x in grads], _to_cpu(st.opt_state),
                          _to_cpu(st.params), 0)
    t_cpu = time.perf_counter() - t0
    exact_p, exact_s = update([x.cpu().double() for x in grads],
                              _to_f64(st.opt_state), _to_f64(st.params), 0)
    # Each leaf's update (new - old params) and each covariance and
    # inverse, against the same update in float64 on the CPU, as a share
    # of the leaf's largest entry.  float32 eigh of (C + damp I) is only
    # as good as its conditioning allows (up to 1 + dim / ng_alpha = 385
    # at 1,536, with a near-rank-one C a cluster of eigenvalues at damp):
    # the card's worst error may be at most 10x the CPU float32's own
    # worst error, or 1e-4
    names = (["/".join(k) for k, _ in pl]
             + ["opt/" + "/".join(k) for k, _ in tree_paths(exact_s)])
    exact = ([e - o.cpu().double() for (_, o), (_, e)
              in zip(pl, tree_paths(exact_p))]
             + [e for _, e in tree_paths(exact_s)])

    def worst_err(new_p, new_s):
        got = ([n.cpu().double() - o.cpu().double() for (_, o), (_, n)
                in zip(pl, tree_paths(new_p))]
               + [x for _, x in tree_paths(new_s)])
        return _worst_share(got, exact, names)

    (e_card, at_card), (e_cpu, at_cpu) = (worst_err(new_p, new_s),
                                          worst_err(ref_p, ref_s))
    n_eigh = sum(("cl" in s) + ("cr" in s) for s in (
        tree_get(new_s["ng"], p) for p, _ in pl))
    print(f"[optimizer ng] update at a recompute step ({n_eigh} eigh): "
          f"card {t_card * 1e3:.1f} ms, CPU {t_cpu * 1e3:.0f} ms; against "
          f"float64, worst share of a leaf's largest entry: card "
          f"{e_card:.2e} ({at_card}), CPU float32 {e_cpu:.2e} ({at_cpu}); "
          f"bar max(10 x CPU, 1e-4) ({gpu})", flush=True)
    _check(e_card <= max(10.0 * e_cpu, 1e-4), "ng update card vs CPU")

    # one float32 ng step through the kernels against the plain den
    step32 = make_train_step(f32_cfg, tc, g)
    st_k, m_k = step32(copy.deepcopy(st), b)
    st_p, m_p = _plain_step(torch, bdc, lambda: step32(copy.deepcopy(st), b),
                            "the plain ng step launched no kernel")
    d_upd = 0.0
    for (path, old), (_, x), (_, y) in zip(pl, tree_paths(st_k.params),
                                           tree_paths(st_p.params)):
        scale = max(float((y - old).abs().max()), 1e-30)
        d_upd = max(d_upd, float((x - y).abs().max()) / scale)
    # the two updates differ by float32 eigh's rounding (each within
    # e_card of the float64 update, as measured above) and by the
    # kernels' gradient error amplified by the conditioning
    tol_upd = 2.0 * e_card + 1e-3
    _hold_f32_step(m_k, m_p, "optimizer ng f32 step",
                   "f32 ng objf kernel vs plain",
                   tail=f"; update |d| {d_upd:.2e} of a leaf's largest (tol "
                        f"2 x {e_card:.2e} + 1e-3)")
    _check(d_upd <= tol_upd, "f32 ng update kernel vs plain")
    return total


def _adam_steps(torch, dev, gpu, what, forward, params, alphas, n_steps,
                loss_fn):
    """n_steps of a model without a train step of its own: forward(params,
    alphas, i) -> (chain, xent, extra_loss, metrics), the chain objective
    through the blocked kernels (loss_fn), backward, and Adam through
    make_optimizer on params (and alphas).  Returns (params, alphas,
    per-step metrics, ms)."""
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.train import OptimizerConfig
    from tdnnf_nas_torch.train.optimizer import (make_optimizer, tree_paths,
                                                 tree_unflatten)
    from tdnnf_nas_torch.train.trainer import _wd_scale

    ocfg = OptimizerConfig(kind="adam", lr_initial=1e-3, lr_final=1e-4,
                           num_steps=100000)
    p_init, p_update = make_optimizer(ocfg, _wd_scale)
    a_init, a_update = make_optimizer(ocfg)
    st = {"p": params, "a": alphas, "po": p_init(params),
          "ao": a_init(alphas)}
    _reset_blocked(bdc)

    def one(i):
        pl, al = tree_paths(st["p"]), tree_paths(st["a"])
        pv = [x.detach().requires_grad_(True) for _, x in pl]
        av = [x.detach().requires_grad_(True) for _, x in al]
        p = tree_unflatten([(k, x) for (k, _), x in zip(pl, pv)])
        a = tree_unflatten([(k, x) for (k, _), x in zip(al, av)])
        chain, xent, extra, m = forward(p, a, i)
        loss, metrics = loss_fn(chain, xent)
        grads = torch.autograd.grad(loss + extra, pv + av)
        with torch.no_grad():
            st["p"], st["po"] = p_update(list(grads[:len(pv)]), st["po"],
                                         st["p"], i)
            if av:
                st["a"], st["ao"] = a_update(list(grads[len(pv):]),
                                             st["ao"], st["a"], i)
        metrics.update(m)
        metrics["alpha_grad"] = [g.detach() for g in grads[len(pv):]]
        return metrics

    out, ms = _timed_steps(torch, one, n_steps)
    _check_launches(bdc, n_steps, what)
    return st["p"], st["a"], out, ms


def _random_heads(torch, params, seed: int):
    """Output heads with seeded N(0, 0.1^2) weights: they start at zero,
    which would make every logit 0 in a card-vs-CPU comparison."""
    gen = torch.Generator().manual_seed(seed)
    out = dict(params)
    for head in ("chain", "xent"):
        w = params[f"output_{head}"]["w"]
        out[f"output_{head}"] = dict(
            params[f"output_{head}"],
            w=(0.1 * torch.randn(w.shape, generator=gen)).to(w.device))
    return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _to_f64(tree):
    """A nested dict of tensors as float64 on the CPU (the reference of
    the float32 card-vs-CPU checks)."""
    if isinstance(tree, dict):
        return {k: _to_f64(v) for k, v in tree.items()}
    return tree.detach().cpu().double()


def _worst_share(got, exact, names):
    """(worst max|got - exact| as a share of exact's largest entry, its
    leaf's name) over paired lists of tensors."""
    return max((float((g.detach().cpu().double() - e).abs().max())
                / max(float(e.abs().max()), 1e-30), n)
               for g, e, n in zip(got, exact, names))


def _bayes_stage(torch, dev, gpu, g, model_cfg, batches):
    """11c: the GP TDNN-F (gptdnnf-layer) at the flagship's width: 4
    bf16 steps (eps from a generator, chain objective through the blocked
    kernels + kl, Adam); a float32 test-mode forward card vs CPU."""
    from tdnnf_nas_torch.models import count_params
    from tdnnf_nas_torch.models.bayes import (BayesTdnnfModelConfig,
                                              apply_bayes_model,
                                              init_bayes_model)
    from tdnnf_nas_torch.train import ChainObjectiveConfig
    from tdnnf_nas_torch.train.objective import chain_objective

    cfg = BayesTdnnfModelConfig(base=model_cfg, gp_activation=True)
    params, bn = init_bayes_model(cfg, torch.Generator().manual_seed(2), dev)
    n_params = count_params(params)
    obj = ChainObjectiveConfig(den_obs_bf16=True)
    gen = torch.Generator(dev)
    state = {"bn": bn}

    def forward(p, a, i):
        gen.manual_seed(100 + i)
        b = batches[i % len(batches)]
        chain, xent, state["bn"], kl = apply_bayes_model(
            cfg, p, state["bn"], b["feats"], b.get("ivectors"), gen,
            train=True)
        state["sup"] = b["sup"]
        return chain, xent, kl, {"kl": kl.detach()}

    torch.cuda.reset_peak_memory_stats(dev)
    params, _, out, ms = _adam_steps(
        torch, dev, gpu, "bayes", forward, params, {}, 4,
        lambda c, x: chain_objective(c, x, g, state["sup"], obj))
    objf = [float(m["objf_mmi"]) for m in out]
    kl = [float(m["kl"]) for m in out]
    _check(all(np.isfinite(objf + kl)), "bayes: objf_mmi and kl finite")
    print(f"[bayes] GP TDNN-F, {n_params:,} params: 4 steps objf_mmi "
          + " ".join(f"{v:.4f}" for v in objf) + " kl "
          + " ".join(f"{v:.4f}" for v in kl)
          + f"; {np.mean(ms[1:]):.2f} ms/step after the first ({ms[0]:.1f}"
          f" ms); peak mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          f" GiB ({gpu})", flush=True)
    # test mode (mean weights), float32, TF32 off: 4 sequences, card vs
    # CPU; the forward_corpus bar of phase 8 (rtol/atol 1e-4)
    f32 = cfg.replace(base=model_cfg.replace(compute_dtype="float32"))
    p = _random_heads(torch, params, 3)
    b = batches[0]
    feats, iv = b["feats"][:4], b["ivectors"][:4]
    c_card, _, _, kl_card = apply_bayes_model(f32, p, state["bn"], feats, iv)
    c_cpu, _, _, kl_cpu = apply_bayes_model(
        f32, _to_cpu(p), _to_cpu(state["bn"]), feats.cpu(), iv.cpu())
    c_card = c_card.cpu()
    err = float((c_card - c_cpu).abs().max())
    ok = bool(torch.allclose(c_card, c_cpu, rtol=1e-4, atol=1e-4))
    print(f"[bayes] f32 test-mode logits {list(c_cpu.shape)} card vs CPU "
          f"max|d| {err:.2e} (|logit| <= {float(c_cpu.abs().max()):.2f}, "
          f"rtol/atol 1e-4); kl card {float(kl_card):.6g} CPU "
          f"{float(kl_cpu):.6g}", flush=True)
    _check(ok, "bayes f32 test-mode forward card vs CPU")
    _check(abs(float(kl_card) - float(kl_cpu)) <= 1e-4 * abs(float(kl_cpu)),
           "bayes kl card vs CPU")
    return 4


def _cnn_chunks(bundle, cfg, n_utts: int, chunk_width: int):
    """Chunks with a CNN-TDNN-F's context from phase 1's corpus, den and
    tree (the first n_utts training utterances)."""
    from tdnnf_nas_torch.data.egs import EgsConfig, make_egs
    from tdnnf_nas_torch.models.cnn import cnn_tdnnf_context

    left, right = cnn_tdnnf_context(cfg)
    ecfg = EgsConfig(chunk_width=chunk_width, left_context=left,
                     right_context=right, tolerance=2,
                     max_phones_per_chunk=40)
    return make_egs(bundle.train_utts[:n_utts], bundle.lm, bundle.topo,
                    bundle.tree, ecfg, den_fsa=bundle.den_fsa)


class _ReluTape:
    """Stands in for ``torch.relu`` for one forward pass and keeps each
    call's input (detached, on the CPU).  Given an earlier pass's tape
    (``replay``), it takes that pass's branch at every unit (its input
    where the earlier one was > 0, else 0), so the gradient follows the
    same branches as the earlier pass's."""

    def __init__(self, torch, replay=None):
        self.relu, self.replay, self.inputs = torch.relu, replay, []

    def __call__(self, x):
        self.inputs.append(x.detach().cpu())
        if self.replay is None:
            return self.relu(x)
        keep = self.replay.inputs[len(self.inputs) - 1] > 0
        return x * keep.to(device=x.device, dtype=x.dtype)


def _cnn_stage(torch, dev, gpu, g, bundle, model_cfg, chunk_width,
               batch_size):
    """11d: CNN-TDNN-F at the flagship's width (conv 32 / 32 (height
    stride 2) / 64 on 40 bins, out_dim 1,280): 4 bf16 steps; the
    ConvDARTS variant's gumbel step; float32 forward + grad card vs
    CPU."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.models import count_params
    from tdnnf_nas_torch.models.cnn import (CnnFrontendConfig,
                                            CnnTdnnfModelConfig,
                                            ConvDartsLayerConfig,
                                            apply_cnn_tdnnf,
                                            cnn_tdnnf_context,
                                            init_cnn_tdnnf)
    from tdnnf_nas_torch.train import ChainObjectiveConfig
    from tdnnf_nas_torch.train.objective import chain_objective

    cfg = CnnTdnnfModelConfig(cnn=CnnFrontendConfig(), tdnnf=model_cfg)
    _check(cfg.cnn.out_dim() == 1280, "CNN front end out_dim 1,280")
    obj = ChainObjectiveConfig(den_obs_bf16=True)
    launches = 0
    for variant in ("conv", "darts"):
        if variant == "darts":
            cfg = cfg.replace(cnn=cfg.cnn.replace(
                layers=(ConvDartsLayerConfig(),) + cfg.cnn.layers[1:]))
        t0 = time.perf_counter()
        chunks = _cnn_chunks(bundle, cfg, 240, chunk_width)
        n_steps = 4 if variant == "conv" else 1
        batches = []
        for b in batch_iterator(chunks, batch_size=batch_size,
                                rng=np.random.RandomState(0)):
            if len(batches) == n_steps:
                break
            batches.append(convert.batch_to_torch(b, dev))
        _check(len(batches) == n_steps and all(
            b["feats"].shape[0] == batch_size for b in batches),
            f"{n_steps} full CNN batches")
        params, alphas, bn = init_cnn_tdnnf(
            cfg, torch.Generator().manual_seed(4), dev)
        if variant == "darts":
            # the output heads start at zero, which leaves every layer
            # below them without a gradient in a first step
            params = _random_heads(torch, params, 7)
        state = {"bn": bn}
        gen = torch.Generator(dev)
        mode = "gumbel" if variant == "darts" else "fixed"

        def forward(p, a, i):
            gen.manual_seed(200 + i)
            b = batches[i]
            chain, xent, state["bn"] = apply_cnn_tdnnf(
                cfg, p, state["bn"], b["feats"], alphas=a, mode=mode,
                tau=1.0, generator=gen, train=True)
            state["sup"] = b["sup"]
            return chain, xent, 0.0, {}

        print(f"[cnn {variant}] {count_params(params):,} params, context "
              f"{cnn_tdnnf_context(cfg)}, {len(chunks)} chunks from 240 "
              f"utterances in {time.perf_counter() - t0:.1f} s, feats "
              f"{list(batches[0]['feats'].shape)}", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
        params, alphas, out, ms = _adam_steps(
            torch, dev, gpu, f"cnn {variant}", forward, params, alphas,
            n_steps, lambda c, x: chain_objective(c, x, g, state["sup"],
                                                  obj))
        launches += n_steps
        objf = [float(m["objf_mmi"]) for m in out]
        _check(all(np.isfinite(objf)), f"cnn {variant}: objf_mmi finite")
        extra = ""
        if variant == "darts":
            ga = out[0]["alpha_grad"][0]
            gmax = float(ga.abs().max())
            _check(bool(torch.isfinite(ga).all()) and gmax > 0,
                   "conv_offsets alphas: finite non-zero gradient")
            now = alphas["conv_offsets"].cpu().numpy().round(6).tolist()
            extra = (f"; conv_offsets grad max|g| {gmax:.3e}, alphas now "
                     f"{now}")
        print(f"[cnn {variant}] {n_steps} {mode} steps objf_mmi "
              + " ".join(f"{v:.4f}" for v in objf)
              + f"; {np.mean(ms[1:] or ms):.2f} ms/step"
              + (" after the first" if n_steps > 1 else "")
              + f" ({ms[0]:.1f} ms first); peak mem "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
              f"{extra} ({gpu})", flush=True)

    _cnn_f32_check(torch, dev, cfg, _random_heads(torch, params, 5), alphas,
                   state["bn"], batches[0]["feats"][:2], chunk_width)
    return launches


def _cnn_f32_check(torch, dev, cfg, p0, alphas, bn, feats,
                   chunk_width):
    """Phase 11d's float32 forward + grad of a CNN-TDNN-F (``cfg``, its
    parameters ``p0``, ``alphas`` and BN state ``bn`` on ``dev``) on
    ``feats``, on ``dev`` against the CPU."""
    # float32 forward + grad, card vs CPU, cuDNN TF32 off: 2 sequences of
    # the DARTS variant in softmax mode (its alphas get a gradient too),
    # with the stored BN statistics.  Of ~4 M ReLU inputs a few lie within
    # float32 rounding of 0 and may take the other side on the other
    # device; each such flip leaves the logits as they were but moves a
    # frame's share of a row of the gradient (up to 4e-2 of a leaf's
    # largest entry and 3.9e-4 of the vector's norm in card runs that
    # passed, past the 1e-3 bar in one that failed).  So the CPU's pass
    # takes the card's branch at every ReLU (``_ReluTape``): every ReLU's
    # input is held card vs CPU, the units whose sign differs must be few
    # and near 0, and then the gradients, as one vector (relative norm of
    # the difference), at 1e-3; the figure without the replay is printed.
    from tdnnf_nas_torch.models.cnn import apply_cnn_tdnnf
    from tdnnf_nas_torch.train.optimizer import tree_paths, tree_unflatten

    f32 = cfg.replace(tdnnf=cfg.tdnnf.replace(compute_dtype="float32"))
    rng = np.random.RandomState(6)
    r = torch.from_numpy(rng.randn(feats.shape[0], chunk_width,
                                   cfg.tdnnf.num_pdfs).astype(np.float32))

    def fwd_grad(p_tree, a_tree, bn_tree, x, rr, tape):
        pl, al = tree_paths(p_tree), tree_paths(a_tree)
        pv = [v.detach().requires_grad_(True) for _, v in pl]
        av = [v.detach().requires_grad_(True) for _, v in al]
        with mock.patch.object(torch, "relu", tape):
            chain, xent, _ = apply_cnn_tdnnf(
                f32, tree_unflatten([(k, v) for (k, _), v in zip(pl, pv)]),
                bn_tree, x,
                alphas=tree_unflatten([(k, v) for (k, _), v in zip(al, av)]),
                mode="softmax", tau=1.0, train=False)
        loss = torch.mean(chain * rr) + torch.mean(xent * rr)
        return chain.detach(), torch.autograd.grad(loss, pv + av)

    def rel_norm(got, ref):
        return float(torch.sqrt(
            sum(torch.sum((a - b).double() ** 2) for a, b in zip(got, ref))
            / sum(torch.sum(b.double() ** 2) for b in ref)))

    card_tape = _ReluTape(torch)
    c_card, g_card = fwd_grad(p0, alphas, bn, feats, r.to(dev), card_tape)
    cpu_args = (_to_cpu(p0), _to_cpu(alphas), _to_cpu(bn), feats.cpu(), r)
    _, g_own = fwd_grad(*cpu_args, _ReluTape(torch))
    cpu_tape = _ReluTape(torch, replay=card_tape)
    c_cpu, g_cpu = fwd_grad(*cpu_args, cpu_tape)
    c_card, g_card = c_card.cpu(), [x.cpu() for x in g_card]
    err = float((c_card - c_cpu).abs().max())
    ok = bool(torch.allclose(c_card, c_cpu, rtol=1e-4, atol=1e-4))
    units, flips, near, x_ok = 0, 0, 0.0, True
    for xc, xg in zip(card_tape.inputs, cpu_tape.inputs):
        top = max(float(xg.abs().max()), 1e-30)
        x_ok &= bool(torch.allclose(xc, xg, rtol=1e-4, atol=1e-4 * top))
        flip = (xc > 0) != (xg > 0)
        units += xg.numel()
        flips += int(flip.sum())
        if flip.any():
            near = max(near, float(torch.maximum(xc[flip].abs(),
                                                 xg[flip].abs()).max())
                       / top)
    rel, rel_own = rel_norm(g_card, g_cpu), rel_norm(g_card, g_own)
    names = ["/".join(k) for k, _ in tree_paths(p0)] + ["alphas"]
    worst, at = _worst_share(g_card, [x.double() for x in g_cpu], names)
    print(f"[cnn f32] logits {list(c_cpu.shape)} card vs CPU max|d| "
          f"{err:.2e} (rtol/atol 1e-4); inputs of {len(cpu_tape.inputs)} "
          f"ReLUs ({units:,} units) equal {x_ok} (rtol 1e-4, atol 1e-4 x "
          f"each's max), {flips} units of other sign on the CPU (bar "
          f"{units // 10000}), the farthest {near:.2e} of its ReLU's max "
          f"input from 0 (bar 1e-3); gradients of {len(g_cpu)} leaves "
          f"(alphas included) with the card's ReLU branches: relative "
          f"norm of the difference {rel:.2e} (bar 1e-3), worst entry "
          f"{worst:.2e} of its leaf's largest ({at}); with the CPU's own "
          f"branches {rel_own:.2e}", flush=True)
    _check(ok, "cnn f32 logits card vs CPU")
    _check(len(card_tape.inputs) == len(cpu_tape.inputs) and x_ok,
           "cnn f32 ReLU inputs card vs CPU")
    _check(flips <= units // 10000 and near <= 1e-3,
           "cnn f32 ReLU units of other sign few and within rounding of 0")
    _check(rel <= 1e-3, "cnn f32 gradients card vs CPU")


def _trainers_phase(torch, dev, gpu, g, bundle, model_cfg, batches,
                    chunk_width, batch_size):
    """Phase 11: the front end, the optimizer kinds, Bayes/GP and
    CNN-TDNN-F on phase 1's den and batches.  Returns the blocked
    kernels' launches of its steps (the comparison steps apart)."""
    t_phase = time.perf_counter()
    _frontend_stage(torch, dev, gpu)
    n = _optimizer_stage(torch, dev, gpu, g, model_cfg, batches)
    n += _bayes_stage(torch, dev, gpu, g, model_cfg, batches)
    n += _cnn_stage(torch, dev, gpu, g, bundle, model_cfg, chunk_width,
                    batch_size)
    print(f"[trainers phase] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"fwd": n, "bwd": n}


# Phase 12: the +-1 tree of tools/pm1_den_scale.py on phase 1's corpus
# (6,034 - 46 forward leaves; the 4-gram LM with 2,000 extra states), the
# training steps through its factored den, and the card-vs-CPU batch
FACTORED_LEAVES, FACTORED_STEPS, FACTORED_CPU_BATCH = 6034 - 46, 10, 2


def _timed(fn, record, name):
    """fn wrapped to add its seconds to record[name]."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            record[name] = record.get(name, 0.0) + time.perf_counter() - t0
    return run


def _factored_scores(torch, obs, g, leaky):
    """(logZ, d(sum logZ)/d obs) of forward_score_factored."""
    from tdnnf_nas_torch.ops.fwdbwd import forward_score_factored

    o = obs.clone().requires_grad_(True)
    z = forward_score_factored(o, g, leaky)
    grad, = torch.autograd.grad(z.sum(), o)
    return z.detach(), grad


def _pm1_factored_setup(utts, phone_seqs, topo) -> dict:
    """Phase 12's host set-up, built by the host worker: the 6,034-pdf +-1
    tree on the flagship corpus and ``prepare_data`` (4-gram phone LM,
    2,000 extra states), whose ``to_blocked`` refuses the committed den
    and which falls back to its factored export.  Returns {"tree",
    "bundle", "secs": each host stage's seconds, "refusal": the messages
    ``to_blocked`` raised}."""
    from unittest import mock

    from tdnnf_nas_torch.graphs import (accumulate_cross_triphone_stats,
                                        build_clustered_cross_triphone_tree)
    from tdnnf_nas_torch.graphs import den_graph as host_den
    from tdnnf_nas_torch.recipes import chain_recipes

    secs, refusal = {}, []
    num_phones = 46
    t0 = time.perf_counter()
    stats = accumulate_cross_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        num_phones, 3)
    tree = build_clustered_cross_triphone_tree(stats,
                                               num_leaves=FACTORED_LEAVES)
    secs["tree"] = time.perf_counter() - t0
    to_blocked = host_den.CompiledDenFsa.to_blocked

    def blocked(self, *args, **kwargs):
        try:
            return to_blocked(self, *args, **kwargs)
        except ValueError as e:
            refusal.append(str(e))
            raise

    with mock.patch.object(chain_recipes, "compile_denominator_fsa",
                           _timed(chain_recipes.compile_denominator_fsa,
                                  secs, "compose")), \
            mock.patch.object(chain_recipes, "estimate_ngram_phone_lm",
                              _timed(chain_recipes.estimate_ngram_phone_lm,
                                     secs, "lm")), \
            mock.patch.object(host_den.CompiledDenFsa, "to_blocked",
                              _timed(blocked, secs, "to_blocked")), \
            mock.patch.object(host_den.CompiledDenFsa, "to_factored",
                              _timed(host_den.CompiledDenFsa.to_factored,
                                     secs, "to_factored")):
        t0 = time.perf_counter()
        bundle = chain_recipes.prepare_data(
            utts, phone_seqs, tree, topo, num_phones, phone_lm_order=4,
            num_extra_lm_states=2000)
        secs["prepare_data"] = time.perf_counter() - t0
    return {"tree": tree, "bundle": bundle, "secs": secs,
            "refusal": refusal}


def _factored_phase(torch, dev, gpu, utts, phone_seqs, topo, iv_rng,
                    dense_bundle, host_worker):
    """Phase 12, the bench-scale +-1 path through the factored den: the
    host worker's +-1 tree on phase 1's corpus (the worker built both)
    and ``prepare_data``'s fallback when ``to_blocked`` refuses
    the committed 4-gram den, the factored scan on the card against the
    CPU (float32, B = 2, T = 50), 10 bf16 flagship steps through it; then
    ``forward_score_sparse`` on phase 5's biphone den against the dense
    kernels, and the native supervision builder with the dense numerator
    on phase 1's utterances.  Returns the host FactoredDenGraph."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.graphs import den_graph as host_den
    from tdnnf_nas_torch.models import TdnnfModelConfig
    from tdnnf_nas_torch.ops.fwdbwd import FactoredDenGraph
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)

    t_phase = time.perf_counter()

    # ---- 12.1 the +-1 tree and prepare_data's factored fallback, built
    # by the host worker on the flagship corpus ----
    built = host_worker.take("pm1_factored", "phase 12's +-1 tree and den")
    tree, bundle = built["tree"], built["bundle"]
    secs, refusal = built["secs"], built["refusal"]
    host = bundle.den_arrays
    fsa = bundle.den_fsa
    _check(isinstance(host, host_den.FactoredDenGraph),
           "prepare_data fell back to the factored den")
    _check(len(refusal) == 1, "to_blocked refused the den")
    print(f"[factored den] to_blocked refused it: {refusal[0]}", flush=True)
    indeg = np.diff(host.dst_bounds)
    g = FactoredDenGraph.from_host(host, dev)
    torch.cuda.synchronize()
    largest = max([a.size for a in vars(host).values()
                   if isinstance(a, np.ndarray)]
                  + [t.numel() for t in vars(g).values()
                     if isinstance(t, torch.Tensor)])
    s_k = fsa.num_states * int(indeg.max())
    print(f"[factored den] +-1 tree {tree.num_pdfs} pdfs; committed 4-gram "
          f"den {fsa.num_states} states, {fsa.num_positions} positions, "
          f"{len(fsa.arc_dst)} arcs, {len(fsa.wildcard_positions)} wildcard "
          f"positions; in-degree K max {int(indeg.max())}, mean "
          f"{float(indeg.mean()):.1f}, {int((indeg > 100).sum())} states over "
          f"100; scan form {g.form!r} (largest den array {largest:,} "
          f"entries, S*K = {s_k:,}); den on the card {g.nbytes / 2**20:.1f} MiB; host "
          f"seconds in the worker: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    _check(tree.num_pdfs == 6034, "6,034 +-1 pdfs")
    _check(fsa.committed and host.trans_pos is None and g.form == "arcs"
           and largest < s_k, "the bench-scale +-1 den takes the arc-list "
           "form, with no [S, K] table")

    # ---- 12.2 the factored scan, card vs CPU, float32, B=2, T=50 ----
    # logZ at rtol 1e-5 and the obs gradient at atol 2e-5 (the blocked
    # den's bar): the card sums the arcs in another order than the CPU
    # (both in float64) and the position sums' float32 cumsum scans in
    # other blocks; two card runs are equal bit for bit (no atomics).
    rng = np.random.RandomState(12)
    obs_np = (rng.randn(FACTORED_CPU_BATCH, FLAGSHIP_CHUNK, tree.num_pdfs)
              * 2.0).astype(np.float32)
    obs = torch.from_numpy(obs_np).to(dev)
    t0 = time.perf_counter()
    z_cpu, gr_cpu = _factored_scores(
        torch, torch.from_numpy(obs_np),
        FactoredDenGraph.from_host(host, "cpu"), 0.1)
    t_cpu = time.perf_counter() - t0
    z1, gr1 = _factored_scores(torch, obs, g, 0.1)
    z2, gr2 = _factored_scores(torch, obs, g, 0.1)
    torch.cuda.synchronize()
    _check(bool(torch.equal(z1, z2) and torch.equal(gr1, gr2)),
           "factored scan runs on the card repeat bit for bit")
    err_z = float((z1.cpu() - z_cpu).abs().max())
    rel_z = float(((z1.cpu() - z_cpu).abs() / z_cpu.abs()).max())
    err_g = float((gr1.cpu() - gr_cpu).abs().max())
    print(f"[factored scan card-vs-CPU f32 B={FACTORED_CPU_BATCH} "
          f"T={FLAGSHIP_CHUNK}] logZ {z1.cpu().numpy()} vs "
          f"{z_cpu.numpy()}: max rel err {rel_z:.3e} (tol 1e-5), abs "
          f"{err_z:.3e}; grad max|err| {err_g:.3e} (tol 2e-5); CPU "
          f"{t_cpu:.1f} s ({gpu})", flush=True)
    _check(bool(torch.isfinite(z1).all() and torch.isfinite(gr1).all()),
           "finite factored scan outputs")
    _check(rel_z <= 1e-5, "factored logZ card vs CPU within rtol 1e-5")
    _check(err_g <= 2e-5, "factored grad card vs CPU within 2e-5")

    # ---- 12.3 10 bf16 flagship steps through the factored den ----
    mc = TdnnfModelConfig(num_pdfs=tree.num_pdfs)
    tc = TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=1e-4, num_steps=100000))
    t0 = time.perf_counter()
    chunks = bundle.egs(mc, chunk_width=FLAGSHIP_CHUNK,
                        max_phones_per_chunk=40)
    batches = []
    for b in batch_iterator(chunks, batch_size=FLAGSHIP_BATCH,
                            rng=np.random.RandomState(0)):
        b["ivectors"] = iv_rng.randn(FLAGSHIP_BATCH, mc.ivector_dim
                                     ).astype(np.float32)
        batches.append(convert.batch_to_torch(b, dev))
        if len(batches) == FACTORED_STEPS + 2:
            break
    t_egs = time.perf_counter() - t0
    _check(len(batches) == FACTORED_STEPS + 2, "enough factored batches")
    state = init_train_state(mc, tc, torch.Generator().manual_seed(0), dev)
    step = make_train_step(mc, tc, g)
    torch.cuda.reset_peak_memory_stats(dev)
    objf, times = [], []
    for i in range(FACTORED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        objf.append(float(m["objf_mmi"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    held = [state]

    def two_steps():
        for b in batches[FACTORED_STEPS:]:
            held[0], _ = step(held[0], b)

    idle = _idle_share(torch, two_steps)
    del held, state
    logits = torch.randn(FLAGSHIP_BATCH, FLAGSHIP_CHUNK, tree.num_pdfs,
                         device=dev, generator=torch.Generator(dev)
                         .manual_seed(3)) * 2.0
    scan_ms = _cuda_ms(torch, lambda: _factored_scores(torch, logits, g,
                                                       0.1), reps=2)
    ms = sorted(t * 1e3 for t in times[1:])
    print(f"[factored train] {len(chunks)} chunks in {t_egs:.1f} s; "
          f"{FACTORED_STEPS} bf16 steps of the flagship 7q (B="
          f"{FLAGSHIP_BATCH}, chunk {FLAGSHIP_CHUNK}, {tree.num_pdfs} pdfs): "
          f"objf_mmi " + " ".join(f"{v:.4f}" for v in objf)
          + f"; after the first step median {ms[len(ms) // 2]:.1f} ms/step "
          f"({ms[0]:.1f}-{ms[-1]:.1f}); one factored scan fwd+bwd "
          f"{scan_ms:.1f} ms (f32 obs, B={FLAGSHIP_BATCH}); peak "
          f"{peak:.2f} GiB; card idle over 2 profiled steps: "
          + (f"{100 * idle[0]:.1f}% ({idle[1]:.1f} ms of kernels in "
             f"{idle[2]:.1f} ms)" if idle else "no device event recorded")
          + f" ({gpu})", flush=True)
    _check(all(np.isfinite(objf)), "objf_mmi finite at every factored step")
    del batches, logits

    # ---- 12.4 forward_score_sparse vs the dense kernels, B=64 ----
    _sparse_check(torch, dev, gpu, dense_bundle)
    # ---- 12.5 native builder and the dense numerator ----
    _dense_numerator_check(torch, dev, gpu, utts, phone_seqs, topo)
    print(f"[factored phase] {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return host


def _sparse_check(torch, dev, gpu, dense_bundle):
    """forward_score_sparse on phase 5's biphone den against the dense
    kernels' logZ on the same outputs, B = 64, T = 50, at the kernels'
    own bar against their plain scan (|dlogZ| <= 1e-3, phase 5).  The
    comparison launches of the dense kernels are not counted."""
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import (DenGraphArrays, SparseDenGraph,
                                            forward_score_sparse)

    den = dense_bundle.den
    sg = SparseDenGraph.from_graph(den, dev)
    dg = DenGraphArrays.from_graph(den, dev)
    logits = torch.randn(FLAGSHIP_BATCH, FLAGSHIP_CHUNK, den.num_pdfs,
                         device=dev, generator=torch.Generator(dev)
                         .manual_seed(4)) * 2.0
    before = _dense_launches(ddc)
    z_s = forward_score_sparse(logits, sg, 0.1)
    z_k = ddc.pallas_forward_score(logits, dg.trans, dg.state_pdf, dg.init,
                                   dg.final, leaky_coef=0.1)
    torch.cuda.synchronize()
    _check(_dense_launches(ddc) == (before[0] + 1, before[1]),
           "the dense forward kernel scanned the comparison once")
    ddc.dense_den_fwd_cuda.launches, ddc.dense_den_bwd_cuda.launches = before
    err = float((z_s - z_k).abs().max())
    sparse_ms = _cuda_ms(torch, lambda: forward_score_sparse(logits, sg,
                                                             0.1))
    print(f"[sparse den] forward_score_sparse on the biphone den (S="
          f"{den.num_states}, K={sg.in_src.shape[1]}) vs the dense kernels, "
          f"B={FLAGSHIP_BATCH} T={FLAGSHIP_CHUNK}: logZ max|err| {err:.3e} "
          f"(tol 1e-3, |logZ|~{float(z_k.abs().mean()):.1f}); sparse "
          f"forward {sparse_ms:.2f} ms ({gpu})", flush=True)
    _check(bool(torch.isfinite(z_s).all()) and err <= 1e-3,
           "sparse logZ within 1e-3 of the dense kernels'")


def _dense_numerator_check(torch, dev, gpu, utts, phone_seqs, topo):
    """The native supervision builder (``native/egs_builder.cc``) on the
    first 50 output frames of 64 of phase 1's utterances at least that
    long (bigram LM, phase 5's biphone tree) against the Python builder
    bit for bit; then its dense graphs through the dense numerator
    (``forward_score`` with the mask, chain_objective's branch without
    ``next_w``) on the card against the same graphs' banded form through
    the linear numerator: logZ within rtol 1e-5."""
    from tdnnf_nas_torch.data import native
    from tdnnf_nas_torch.graphs import (BiphoneTree, estimate_phone_lm,
                                        make_chunk_supervision)
    from tdnnf_nas_torch.ops.fwdbwd import forward_score, forward_score_linear

    num_phones, width, s = 46, FLAGSHIP_CHUNK, 80
    lm = estimate_phone_lm(phone_seqs, num_phones)
    tree = BiphoneTree(num_phones, num_leaves=6034 - num_phones)
    cases = []
    for u in utts:
        b, e = np.asarray(u.begins), np.asarray(u.ends)
        idx = np.nonzero(b < width)[0]
        # an utterance shorter than the chunk leaves its last frames
        # without an allowed state (make_egs skips those too)
        if e.max() >= width - 1 and 1 <= len(idx) <= s // 2:
            cases.append(([int(u.phones[i]) for i in idx],
                          np.clip(b[idx], 0, width - 1).tolist(),
                          np.clip(e[idx], 0, width - 1).tolist()))
        if len(cases) == FLAGSHIP_BATCH:
            break
    _check(len(cases) == FLAGSHIP_BATCH, "64 chunks for the native builder")
    fwd, slf = native.tree_tables(tree, num_phones)
    t0 = time.perf_counter()
    out = native.build_supervision_batch_native(
        [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases],
        lm.probs, fwd, slf, None, None, topo.self_loop_prob, 2, width, s)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = [make_chunk_supervision(ph, bg, en, lm, topo, tree, width, s,
                                   tol=2) for ph, bg, en in cases]
    t_py = time.perf_counter() - t0
    for f in ("trans", "state_pdf", "init", "final", "mask"):
        _check(np.array_equal(out[f], np.stack([getattr(r, f)
                                                for r in refs])),
               f"native supervision {f} equals the Python builder's")
    trans = torch.from_numpy(out["trans"]).to(dev)
    evens = torch.arange(0, s, 2, device=dev)
    next_w = trans[:, evens, (evens + 2) % s].clone()
    next_w[:, -1] = 0.0
    pdf, init, final, mask = (torch.from_numpy(out[k]).to(dev) for k in
                              ("state_pdf", "init", "final", "mask"))
    logits = torch.randn(FLAGSHIP_BATCH, width, tree.num_pdfs, device=dev,
                         generator=torch.Generator(dev).manual_seed(5))
    z_dense = forward_score(logits, trans, pdf, init, final, mask=mask)
    z_lin = forward_score_linear(logits, next_w, pdf, init, final, mask,
                                 topo.self_loop_prob)
    _check(bool((z_lin > -1e29).all()), "every chunk has a numerator path")
    rel = float(((z_dense - z_lin).abs() / z_lin.abs()).max())
    print(f"[dense numerator] native builder {t_native * 1e3:.1f} ms for "
          f"{FLAGSHIP_BATCH} chunks (Python {t_py * 1e3:.1f} ms), equal bit "
          f"for bit; dense vs linear numerator logZ on the card max rel err "
          f"{rel:.3e} (tol 1e-5) ({gpu})", flush=True)
    _check(bool(torch.isfinite(z_dense).all()) and rel <= 1e-5,
           "dense numerator logZ equals the linear numerator's")


# Phase 13: data parallel on the one card, flagship 7q in float32 with
# dropout on phase 1's blocked den: 12 steps of the global batch of 64,
# split 32 / 32 over two gloo ranks, against one process at 64, with each
# optimizer kind of DP_KINDS
DP_STEPS, DP_RANKS, DP_TIMEOUT_S, DP_DROPOUT = 12, 2, 600, 0.1
DP_KINDS = {"sgd": 1e-2, "adam": 1e-3}  # kind: lr_initial
# phase 13's witness bars.  At every step, the leaf whose gradient the
# ranks move farthest from one process's (each leaf's gap over its largest
# entry) may be moved DP_ORDER_TIMES as far as the leaf that reordering
# the batch's rows in one process moves farthest (float32 order noise: a
# gradient that cancels, as a bias before ReLU and batchnorm, moves by
# 1e-2 of its largest entry).  Leaf by leaf the two do not compare: a
# reordering leaves every product's shape, and so its kernel, as it was,
# where the ranks multiply 32 rows in place of 64.  An element whose two
# gradients differ by more than a tenth of their size is one whose float32
# sum cancels to rounding noise.  Where they agree to DP_AGREE, Adam's
# step moves by at most about (1 - beta1) / bc1 * DP_AGREE * lr = 5.3e-7:
# such params must stay within DP_AGREE_ATOL, 10x that.
DP_ORDER_TIMES = 10
DP_NOISE_SHARE, DP_PARAM_ATOL = 0.1, 5e-4
DP_AGREE, DP_AGREE_ATOL = 1e-3, 5e-6


def _save_dp_inputs(path, host_den, host_batches, dev) -> None:
    """Phase 1's host den and batches and the device the ranks share, for
    the ranks of phase 13."""
    arrays = {"device": np.asarray(str(dev))}
    arrays.update({f"den|{k}": v
                   for k, v in dataclasses.asdict(host_den).items()
                   if isinstance(v, np.ndarray)})
    arrays["den|ints"] = np.asarray([host_den.enter_pad,
                                     host_den.num_states,
                                     host_den.num_pdfs])
    for i, b in enumerate(host_batches):
        arrays[f"{i}|feats"] = b["feats"]
        arrays[f"{i}|ivectors"] = b["ivectors"]
        for f in ("trans", "state_pdf", "init", "final", "mask", "next_w"):
            arrays[f"{i}|sup.{f}"] = getattr(b["sup"], f)
    arrays["self_loop_prob"] = np.asarray(
        host_batches[0]["sup"].self_loop_prob)
    np.savez(path, **arrays)


def _load_dp_inputs(path):
    """(host BlockedDenGraph, host batches, device name) written by
    _save_dp_inputs."""
    from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph
    from tdnnf_nas_torch.graphs.supervision import ChunkSupervision

    z = np.load(path)
    enter_pad, num_states, num_pdfs = (int(v) for v in z["den|ints"])
    fields = {f.name: z[f"den|{f.name}"] if f"den|{f.name}" in z else None
              for f in dataclasses.fields(BlockedDenGraph)
              if f.name not in ("enter_pad", "num_states", "num_pdfs")}
    den = BlockedDenGraph(**fields, enter_pad=enter_pad,
                          num_states=num_states, num_pdfs=num_pdfs)
    batches = []
    for i in range(len([k for k in z.files if k.endswith("|feats")])):
        sup = ChunkSupervision(
            **{f: z[f"{i}|sup.{f}"] for f in ("trans", "state_pdf", "init",
                                              "final", "mask", "next_w")},
            self_loop_prob=float(z["self_loop_prob"]))
        batches.append({"feats": z[f"{i}|feats"],
                        "ivectors": z[f"{i}|ivectors"], "sup": sup})
    return den, batches, str(z["device"])


class _Reordered:
    """A one-process stand-in for a mesh, for the step of a batch whose
    rows were put in the order ``rows``: each dropout mask's rows follow
    them, and nothing is reduced.  The step is then the unordered one's
    but for the order of the float32 sums over the rows."""

    size = 1

    def __init__(self, torch, rows, dev):
        self._rows = torch.as_tensor(rows, device=dev)

    def rows(self, global_rows):
        return self._rows

    def all_reduce_grad(self, x):
        return x

    def all_reduce_sum(self, tensors):
        return list(tensors)

    def all_reduce_metrics(self, metrics):
        return metrics


def _witness_gaps(prior, got, want, reordered, beta1):
    """One step of the ranks (``got``) against the witness's (``want``)
    from the same state ``prior``; ``reordered``: the witness's step on
    the batch's rows in another order, or None.  Returns ([the largest
    |param gap|, the elements whose params are more than DP_PARAM_ATOL
    apart, the least |gradient gap| / |gradient| among them (inf without
    one), the largest |param gap| where the gradients agree to DP_AGREE],
    per leaf [the ranks' |gradient gap| to the witness, the reordering's
    |gradient gap| to it], each over the leaf's largest |gradient|).  Gradients are read back from Adam's
    first moment (``_adam_grads``); without ``reordered`` only the param
    gap is taken, the other columns NaN and no leaf rows."""
    from tdnnf_nas_torch.train.optimizer import tree_get, tree_paths

    p_gap, n_far, least = 0.0, 0, float("inf")
    agree_gap = float("nan") if reordered is None else 0.0
    grads = ([] if reordered is None else
             [_adam_grads(prior, s, beta1) for s in (got, want, reordered)])
    leaves = []
    for path, x in tree_paths(got.params):
        d = (x - tree_get(want.params, path)).abs()
        p_gap = max(p_gap, float(d.max()))
        if reordered is None:
            continue
        g_got, g_want, g_b = (g["/".join(path)] for g in grads)
        dg, size = (g_got - g_want).abs(), g_want.abs()
        leaves.append([
            float(dg.max() / size.max().clamp(min=1e-30)),
            float((g_b - g_want).abs().max() / size.max().clamp(
                min=1e-30))])
        far = d > DP_PARAM_ATOL
        n_far += int(far.sum())
        if bool(far.any()):
            least = min(least, float((dg[far] / size[far].clamp(
                min=1e-30)).min()))
        agree = dg <= DP_AGREE * size
        if bool(agree.any()):
            agree_gap = max(agree_gap, float(d[agree].max()))
    return [p_gap, n_far, least, agree_gap], np.asarray(leaves)


def _adam_grads(prior, post, beta1):
    """{leaf path: the gradient of the step prior -> post}, read back from
    Adam's first moment, m' = beta1 m + (1 - beta1) g."""
    from tdnnf_nas_torch.train.optimizer import tree_get, tree_paths

    return {"/".join(p): (x - beta1 * tree_get(prior.opt_state["m"], p))
            / (1 - beta1) for p, x in tree_paths(post.opt_state["m"])}


def _params_checksum(params):
    """[leaves, 2] float64 sums and sums of squares of every leaf."""
    from tdnnf_nas_torch.train.optimizer import tree_paths

    return np.asarray([[float(x.double().sum()), float(x.double().square()
                                                        .sum())]
                       for _, x in tree_paths(params)])


def _dp_train(torch, dev, g, host_batches, mesh, num_pdfs, kind,
              steps=DP_STEPS, witness=False):
    """``steps`` float32 flagship steps with dropout from one seeded state
    with optimizer ``kind``, on ``mesh``'s rows of each global batch or,
    without one, the whole batch.  With ``witness`` one process also
    takes each step on the whole batch from a copy of the state before
    it, and with Adam once more on the batch's rows in a seeded random
    order (``_Reordered``).  Returns (objf per step, ms per step, params
    on the host after the first and the last step, blocked kernel
    launches of the steps, the final params' checksums, and with
    ``witness`` [steps, 5]: each step's |objf - the witness's| and its
    ``_witness_gaps`` (else None), and [steps, leaves, 2] its per-leaf
    gradient gaps with Adam)."""
    from tdnnf_nas_torch import convert, parallel
    from tdnnf_nas_torch.models import TdnnfModelConfig
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.train import (OptimizerConfig, TrainerConfig,
                                       init_train_state, make_train_step)
    from tdnnf_nas_torch.train.optimizer import tree_paths

    mc = TdnnfModelConfig(num_pdfs=num_pdfs, compute_dtype="float32",
                          dropout_proportion=DP_DROPOUT)
    tc = TrainerConfig(optimizer=OptimizerConfig(
        kind=kind, lr_initial=DP_KINDS[kind], lr_final=DP_KINDS[kind] / 10,
        num_steps=100000))
    state = init_train_state(mc, tc, torch.Generator().manual_seed(0), dev)
    if mesh is not None:
        state = parallel.put_replicated(state, mesh)
    step = make_train_step(mc, tc, g, seed=1, mesh=mesh)
    one = make_train_step(mc, tc, g, seed=1) if witness else None
    objf, ms, params, gaps, leaf_gaps = [], [], [], [], []
    launches = np.zeros(2, np.int64)

    def host_params():
        return {"/".join(p): x.cpu().numpy()
                for p, x in tree_paths(state.params)}

    for i in range(steps):
        b = host_batches[i % len(host_batches)]
        local = (convert.batch_to_torch(b, dev) if mesh is None
                 else parallel.put_batch(b, mesh))
        prior = copy.deepcopy(state) if witness else None
        if mesh is not None:  # no rank's time holds rank 0's witness
            torch.distributed.barrier(group=mesh.group)
        before = _blocked_launches(bdc)
        t0 = time.perf_counter()  # the last step's objf fetch synchronised
        state, m = step(state, local)
        objf.append(float(m["objf_mmi"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        launches += np.subtract(_blocked_launches(bdc), before)
        _check(np.isfinite(objf[-1]), "objf_mmi finite at every dp step")
        if witness:
            reordered = None
            if kind == "adam":  # the same step, the rows in another order
                rows = np.random.RandomState(i).permutation(len(b["feats"]))
                reordered = make_train_step(
                    mc, tc, g, seed=1, mesh=_Reordered(torch, rows, dev))(
                        copy.deepcopy(prior), convert.batch_to_torch(
                            convert.map_batch(lambda _, a: a[rows], b),
                            dev))[0]
            w_state, w_m = one(prior, convert.batch_to_torch(b, dev))
            row, per_leaf = _witness_gaps(prior, state, w_state, reordered,
                                          tc.optimizer.beta1)
            gaps.append([abs(float(w_m["objf_mmi"]) - objf[-1])] + row)
            leaf_gaps.append(per_leaf)
            del prior, w_state, reordered
        if i in (0, steps - 1):
            params.append(host_params())
    return (objf, ms, params, launches.tolist(),
            _params_checksum(state.params),
            np.asarray(gaps) if witness else None, np.asarray(leaf_gaps))


def _dp_rank_main(work: str) -> int:
    """One rank of phase 13, started by ``_dp_phase`` as ``python3
    chip_smoke.py --dp-rank DIR`` with COORDINATOR_ADDRESS, NUM_PROCESSES
    and PROCESS_ID set: gloo with CUDA tensors, every rank on the
    parent's card; writes its trajectory, times, launches (and rank 0 its
    parameters and the one-process witness of each step) to DIR."""
    import torch

    sys.path.insert(0, REPO)
    from tdnnf_nas_torch import parallel
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host_den, host_batches, device = _load_dp_inputs(
        os.path.join(work, "inputs.npz"))
    _check(parallel.initialize_from_env(backend="gloo", device=device),
           "the rank found its coordinator")
    mesh = parallel.make_mesh(device=device)
    g = BlockedDenGraph.from_host(host_den, mesh.device)
    out = {}
    for kind in DP_KINDS:
        before = _blocked_launches(bdc)
        objf, ms, params, launches, checksum, gaps, leaf_gaps = _dp_train(
            torch, mesh.device, g, host_batches, mesh, host_den.num_pdfs,
            kind, witness=mesh.rank == 0)
        out.update({f"{kind}|objf": np.asarray(objf),
                    f"{kind}|ms": np.asarray(ms),
                    f"{kind}|checksum": checksum,
                    f"{kind}|launches": np.asarray(launches),
                    f"{kind}|all_launches": np.subtract(
                        _blocked_launches(bdc), before)})
        if mesh.rank == 0:
            out[f"{kind}|witness"] = gaps
            out[f"{kind}|leaf_gaps"] = leaf_gaps
            out.update({f"{kind}|param{j}|{k}": v
                        for j, ps in enumerate(params)
                        for k, v in ps.items()})
    np.savez(os.path.join(work, f"rank{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


def _dp_nccl_main(work: str) -> int:
    """Phase 13's one-rank NCCL group, started by ``_dp_phase`` as
    ``python3 chip_smoke.py --dp-nccl DIR`` with COORDINATOR_ADDRESS,
    NUM_PROCESSES=1 and PROCESS_ID=0 set: one ``adam`` step on the card
    from phase 13's inputs in DIR; writes its objf, time and launches to
    DIR/nccl.npz."""
    import torch

    sys.path.insert(0, REPO)
    from tdnnf_nas_torch import parallel
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host_den, host_batches, _ = _load_dp_inputs(
        os.path.join(work, "inputs.npz"))
    _check(parallel.initialize_from_env(), "the NCCL group started")
    try:
        _check(torch.distributed.get_backend() == "nccl", "NCCL backend")
        mesh = parallel.make_mesh()
        g = BlockedDenGraph.from_host(host_den, mesh.device)
        objf, ms, _, launches = _dp_train(torch, mesh.device, g,
                                          host_batches, mesh,
                                          host_den.num_pdfs, "adam",
                                          steps=1)[:4]
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(work, "nccl.npz"), objf=np.asarray(objf),
             ms=np.asarray(ms), launches=np.asarray(launches))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_phase(torch, dev, gpu, host_den, host_batches):
    """Phase 13, data parallel on the one card: two ranks over gloo with
    CUDA tensors (NCCL refuses two ranks on one device, so this is the
    only two-rank check one card allows), started through
    ``initialize_from_env`` in processes of their own, each stepping on
    32 rows of the global batch of 64, against one process at 64 in this
    one; then one step of a one-rank NCCL group, the production backend,
    in a process of its own (``_dp_nccl_main``).  Returns the blocked
    kernels' launches of every step of the phase."""
    import tempfile

    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.models import (TdnnfModelConfig, apply_model,
                                        init_model)
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

    t_phase = time.perf_counter()
    g = BlockedDenGraph.from_host(host_den, dev)
    ref = {kind: _dp_train(torch, dev, g, host_batches, None,
                           host_den.num_pdfs, kind) for kind in DP_KINDS}
    # the ranks' first half of the batch alone and within the whole batch,
    # with stored batchnorm statistics (no coupling between rows): the
    # products of 32 rows take other kernels than those of 64
    mc = TdnnfModelConfig(num_pdfs=host_den.num_pdfs,
                          compute_dtype="float32")
    params, bn = init_model(mc, torch.Generator().manual_seed(0), dev)
    params = _random_heads(torch, params, 0)
    b = convert.batch_to_torch(host_batches[0], dev)
    half = FLAGSHIP_BATCH // DP_RANKS
    with torch.no_grad():
        whole = apply_model(mc, params, bn, b["feats"], b["ivectors"],
                            train=False)[0]
        alone = apply_model(mc, params, bn, b["feats"][:half],
                            b["ivectors"][:half], train=False)[0]
    fwd_gap = float((whole[:half] - alone).abs().max() / whole.abs().max())
    del params, bn, whole, alone
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        _save_dp_inputs(os.path.join(work, "inputs.npz"), host_den,
                        host_batches, dev)
        port = _free_port()
        procs = []
        for rank in range(DP_RANKS):
            env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                       NUM_PROCESSES=str(DP_RANKS), PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank",
                 work], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(f"[dp] rank {rank} exited {p.returncode}:\n"
                      f"{log[-4000:]}", flush=True)
            _check(p.returncode == 0, f"dp rank {rank} ran to its end")
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                 for r in range(DP_RANKS)]
        # ---- one step of a one-rank NCCL group, in its own process ----
        env = dict(os.environ,
                   COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
                   NUM_PROCESSES="1", PROCESS_ID="0")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-nccl", work],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            log = proc.communicate(timeout=DP_TIMEOUT_S)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            print(f"[dp] the NCCL rank exited {proc.returncode}:\n"
                  f"{log[-4000:]}", flush=True)
        _check(proc.returncode == 0, "the NCCL rank ran to its end")
        nccl = dict(np.load(os.path.join(work, "nccl.npz")))
    launches = np.sum([ref[k][3] for k in DP_KINDS], axis=0)
    for kind in DP_KINDS:
        ref_objf, ref_ms, ref_params = ref[kind][:3]
        got = ranks[0][f"{kind}|objf"]
        d_objf = float(np.max(np.abs(got - np.asarray(ref_objf))))
        leaf_gap = [{k: float(np.max(np.abs(
            ranks[0][f"{kind}|param{j}|{k}"] - v)))
            for k, v in ref_params[j].items()} for j in (0, 1)]
        d_param = [max(gaps.values()) for gaps in leaf_gap]
        worst = sorted(leaf_gap[1].items(), key=lambda kv: -kv[1])[:3]
        witness = ranks[0][f"{kind}|witness"]
        rank_launches = [r[f"{kind}|launches"].tolist() for r in ranks]
        launches = launches + np.sum([r[f"{kind}|all_launches"]
                                      for r in ranks], axis=0)
        for r in ranks[1:]:
            _check(np.array_equal(r[f"{kind}|objf"], got),
                   "every rank reports the global objf")
        print(f"[dp gloo x{DP_RANKS}, one card, {kind} lr "
              f"{DP_KINDS[kind]:g}] objf_mmi "
              + " ".join(f"{v:.6f}" for v in got)
              + f"; one process at B={FLAGSHIP_BATCH}: "
              + " ".join(f"{v:.6f}" for v in ref_objf)
              + f"; max|d objf| {d_objf:.2e}; params max|d| after the first "
              f"step {d_param[0]:.2e}, after {DP_STEPS} steps "
              f"{d_param[1]:.2e}; launches per rank (fwd, bwd) "
              f"{rank_launches}; ms/step median: ranks "
              + ", ".join(f"{np.median(r[f'{kind}|ms'][1:]):.1f}"
                          for r in ranks)
              + f", one process {np.median(ref_ms[1:]):.1f} ({gpu})",
              flush=True)
        far = witness[:, 2] > 0
        print(f"[dp witness, {kind}] one process on the whole batch from "
              f"the ranks' state before each step: |d objf| per step "
              + " ".join(f"{v:.1e}" for v in witness[:, 0])
              + "; params max|d| after each step "
              + " ".join(f"{v:.1e}" for v in witness[:, 1])
              + f"; the leaves farthest from the one-process run after "
              f"{DP_STEPS} steps: "
              + ", ".join(f"{k} {v:.2e}" for k, v in worst), flush=True)
        expect = DP_STEPS * (3 if kind == "adam" else 2)
        _check(all(l == [DP_STEPS, DP_STEPS] for l in rank_launches),
               "each rank launched each blocked kernel once a step")
        _check(ranks[0][f"{kind}|all_launches"].tolist() == [expect] * 2,
               "rank 0's witness launched each blocked kernel once a step")
        for r in ranks[1:]:
            _check(np.array_equal(r[f"{kind}|checksum"],
                                  ranks[0][f"{kind}|checksum"]),
                   f"{kind}: every rank holds the same params after "
                   f"{DP_STEPS} steps")
        # the first step: objf at rtol 1e-5 and params at atol 5e-4
        # (tests/test_parallel.py:49-70)
        _check(abs(got[0] - ref_objf[0]) <= 1e-5 * abs(ref_objf[0]),
               f"{kind}: the first step's objf within rtol 1e-5")
        _check(d_param[0] <= DP_PARAM_ATOL, f"{kind}: params after one "
               "step within 5e-4")
        # every step from the ranks' own state, as the first step from
        # the common one: the witness's objf at rtol 1e-5.  A rank that
        # drifted in its optimizer state, its step count or its rows
        # fails here or below at the step it goes wrong.
        _check(bool(np.all(witness[:, 0] <= 1e-5 * np.abs(got))),
               f"{kind}: every step's objf within rtol 1e-5 of one "
               "process's from the same state")
        if kind == "adam":
            # the ranks' gradient differs from one process's no more than
            # reordering the rows does (10x, the worst leaves); Adam's
            # g / sqrt(v) sets params more than 5e-4 apart only where the
            # gradient is itself rounding noise, and leaves the rest within
            # 5e-6
            gl = ranks[0][f"{kind}|leaf_gaps"]  # [steps, leaves, 2]
            names = list(ref_params[0])
            worst_dp, worst_re = gl[:, :, 0].max(axis=1), gl[:, :, 1].max(
                axis=1)
            ratio = gl[:, :, 0] / np.maximum(gl[:, :, 1], 1e-30)
            s_w, l_w = np.unravel_index(np.argmax(ratio[1:]), ratio[1:].shape)
            print(f"[dp witness, adam gradients] each leaf's |ranks - one "
                  f"process| / its max|g|, against the same for the rows "
                  f"reordered in one process: the worst leaf per step "
                  + " ".join(f"{v:.1e}/{u:.1e}" for v, u in zip(worst_dp,
                                                                 worst_re))
                  + "; per leaf from step 2, ratio median per step "
                  + " ".join(f"{v:.2f}" for v in np.median(ratio[1:], axis=1))
                  + f", largest {ratio[1 + s_w, l_w]:.0f} ({names[l_w]}, "
                  f"step {s_w + 2}: {gl[1 + s_w, l_w, 0]:.1e} against "
                  f"{gl[1 + s_w, l_w, 1]:.1e}); the same rows alone and "
                  f"within the batch of {FLAGSHIP_BATCH}, stored batchnorm "
                  f"statistics: max|d logit| / max|logit| {fwd_gap:.1e}; "
                  f"params more than {DP_PARAM_ATOL:g} apart per step "
                  + " ".join(f"{int(v)}" for v in witness[:, 2])
                  + ", their least |d g| / |g| "
                  + (f"{witness[far, 3].min():.2f}" if far.any() else "-")
                  + f"; params max|d| where the gradients agree to "
                  f"{DP_AGREE:g}, per step "
                  + " ".join(f"{v:.1e}" for v in witness[:, 4]), flush=True)
            _check(bool(np.all(worst_dp <= DP_ORDER_TIMES * worst_re)),
                   "adam: every step's gradient within 10x the row-order "
                   "noise of one process's from the same state")
            _check(bool(np.all(witness[far, 3] > DP_NOISE_SHARE)),
                   "adam: params more than 5e-4 apart only where the two "
                   "gradients differ by over a tenth of their size")
            _check(bool(np.all(witness[:, 4] <= DP_AGREE_ATOL)),
                   "adam: params within 5e-6 where the two gradients agree "
                   "to 1e-3")
        else:
            _check(bool(np.all(witness[:, 1] <= DP_PARAM_ATOL)),
                   f"{kind}: every step's params within 5e-4 of one "
                   "process's from the same state")
        if kind == "sgd":
            # 12 steps: the trajectory within 5e-4 (__graft_entry__.py:119)
            # and the params within 5e-4.  Adam's g / sqrt(v) turns the
            # float32 reduction-order differences of each step (held
            # above) into lr-sized steps where a gradient entry is
            # rounding noise (the reference's own note, tests/
            # test_parallel.py:65-66), and they compound over the steps;
            # its trajectory is printed, not held to these bars.
            _check(d_objf < 5e-4, "sgd: the objf trajectory within 5e-4")
            _check(d_param[1] <= 5e-4, f"sgd: params after {DP_STEPS} "
                   "steps within 5e-4")

    objf, ms = nccl["objf"], nccl["ms"]
    nccl_launch = nccl["launches"].tolist()
    _check(nccl_launch == [1, 1], "the NCCL step launched each kernel once")
    ref_adam = ref["adam"][0][0]
    print(f"[dp nccl x1] one adam step: objf_mmi {objf[0]:.6f} (one "
          f"process: {ref_adam:.6f}), {ms[0]:.1f} ms with its first "
          f"launches; [dp phase] {time.perf_counter() - t_phase:.1f} s "
          f"({gpu})", flush=True)
    _check(abs(objf[0] - ref_adam) <= 1e-5 * abs(ref_adam),
           "the NCCL step's objf within rtol 1e-5")
    n = launches + np.asarray(nccl_launch)
    return {"fwd": int(n[0]), "bwd": int(n[1])}


# Phase 14: the whole flagship run of tools/e2e_flagship at the reference's
# smoke sizes.  The keys each of the reference's three files holds
# (scripts/e2e_flagship.py:93-98, 157-159, 195-196, 223-224, 298-301,
# 314-315, 325, 338, 380, 397, 422-423, 460; :446-455; :689-710) ...
E2E_KEYS = {
    "e2e": {"corpus", "gmm", "ivectors", "tree_pdfs", "den_states", "train",
            "hclg", "wer_first_pass_tg", "wer_4gram_rescore",
            "wer_rnnlm_rescore", "lhuc", "lhuc_noiv", "bf16_parity"},
    "corpus": {"vocab", "phones", "train_utts", "test_utts", "audio_hours",
               "noise", "speakers", "lm_text_sents"},
    "gmm": {"fmllr_gain", "train_subset", "seconds"},
    "ivectors": {"dim", "within_spk_cos", "between_spk_cos"},
    "train": {"steps", "objf_mmi", "params", "seconds", "egs_stats"},
    "hclg": {"states", "arcs", "build_s"},
    "lhuc": {"speakers", "utts", "wer_before", "wer_after"},
    "lhuc_noiv": {"speakers", "utts", "wer_before", "wer_after",
                  "wer_unadapted_full"},
    "bf16_parity": {"delta_wer"},
    "bf16": {"bfloat16", "float32", "delta_wer", "note"},
    "dtype": {"objf_final", "objf_curve_10", "wer"},
    "search": {"scale", "alpha_entropy", "alpha_entropy_seed2",
               "alpha_entropy_uniform", "cv_steps", "top1_logprob",
               "seed_top1_agreement", "table"},
    "row": {"strides", "lookahead_reach", "params", "train_objf", "dev_objf",
            "wer"},
}
# ... and the reference's own full-scale figures (docs/e2e_flagship.json,
# bf16_parity.json, search_table_flagship.json), printed beside the smoke
# run's, never held: at 20 test utterances one word moves WER by ~0.7
E2E_REFERENCE = {"wer_first_pass_tg": 7.44, "wer_4gram_rescore": 7.2,
                 "wer_rnnlm_rescore": 7.39, "lhuc": "7.44 -> 7.34",
                 "lhuc_noiv": "8.47 -> 8.47", "objf_mmi": -0.1068,
                 "objf_final": "-0.2029 / -0.2034", "ab_wer": "10.43 / 10.43",
                 "table": {"searched_top1": 11.11, "searched_top2": 9.45,
                           "searched_seed2_top1": 11.11,
                           "random_arch": 16.15, "random_arch2": 13.22,
                           "manual_baseline": 10.43}}


# phase 14's cut of the reference's smoke sizes (20 test utterances, whose
# speakers LHUC adapts twice; the RNNLM's 150, the no-i-vector model's
# 120 and the A/B's 60 steps; stage 9's pretrain 80, cv-updates 60 and
# children 100 steps) to leave phase 15 its room in the script's time
# limit: with 20 test utterances and stage 9 cut alone the script took
# 1,105.0 s of its 1,200 s, and with 10 test utterances 999.6-1,189.7 s;
# with phase 16 added and 10 test utterances, 836.4-853.9 s on a fast host,
# ~1,150 s projected on a host as slow as the 1,189.7 s run's: 4 test
# utterances (LHUC's two passes over their speakers and the n-best lists
# were ~70 s of phase 14's 200 s at 10)
E2E_CUT = dict(n_test=4, rnnlm_steps=50, noiv_steps=40, ab_steps=30,
               pretrain_steps=40, cv_steps=30, child_steps=25)


def _walk(tree, path=()):
    """(key path, leaf) of a JSON tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _kernel_vs_plain_step(torch, dev, bundle, cfg32, tc32, chunk_width: int,
                          batch_size: int, what: str):
    """One float32 step of ``cfg32`` on ``bundle``'s den through the kernels
    and through the plain scan, from one state on one batch (phase 4's
    bars: objf 1e-4, ``grad_norm`` 1e-3 relative).  A dense den takes the
    dense pair, any other the blocked pair."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data.egs import batch_iterator
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.train import init_train_state, make_train_step

    dense = isinstance(bundle.den_arrays, DenGraphArrays)
    mod = ddc if dense else bdc
    counts = _dense_launches if dense else _blocked_launches
    host = next(batch_iterator(bundle.egs(cfg32, chunk_width=chunk_width),
                               batch_size, np.random.RandomState(0)))
    batch = convert.batch_to_torch(host, dev)
    st0 = init_train_state(cfg32, tc32, torch.Generator().manual_seed(0), dev)
    step32 = make_train_step(cfg32, tc32, den_on_device(bundle, dev), seed=1)
    n0 = counts(mod)
    _, m_k = step32(copy.deepcopy(st0), batch)
    _check(counts(mod) == tuple(n + 1 for n in n0), f"{what}: the kernel "
           "step launched each kernel once")
    _, m_p = _plain_step(torch, mod,
                         lambda: step32(copy.deepcopy(st0), batch),
                         f"{what}: the plain step launched no kernel")
    _hold_f32_step(m_k, m_p, f"{what} f32 step",
                   f"{what}: f32 objf kernel vs plain",
                   head=f"{'dense' if dense else 'blocked'} den, "
                        f"B={batch_size}: ")


def _e2e_phase(torch, dev, gpu):
    """Phase 14: ``tools/e2e_flagship.main(["all", "--smoke", ...])`` in
    this process, the flagship 7q at full width, no bootstrap cache, a
    fresh output directory; then its three files' keys, finite objf and
    WER, the A/B's WER difference, the den's blocked form, one launch of
    each blocked kernel per training, supernet, cv-update, child and LHUC
    step and of the forward per valid batch, the table's rows; then one
    float32 step of the run's model and trainer on its den through the
    kernels against the plain scan.  Returns (the blocked launches of the
    run, its set-up, the content of its ``e2e_flagship.json``); phase 16
    runs on that set-up."""
    import tempfile

    from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph
    from tdnnf_nas_torch.models import count_params
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.tools import e2e_flagship as e2e

    t_phase = time.perf_counter()
    _check(not torch.distributed.is_initialized(),
           "no process group left from phase 13")
    torch.cuda.empty_cache()
    _reset_blocked(bdc)
    with tempfile.TemporaryDirectory() as out:
        sizes = dataclasses.replace(e2e.E2eSizes.smoke(), **E2E_CUT)
        smoke = e2e.E2eSizes.smoke()
        print("[e2e run] cut from the smoke sizes: " + ", ".join(
            f"{k} {getattr(sizes, k)} (smoke {getattr(smoke, k)})"
            for k in E2E_CUT), flush=True)
        boot, stage = {}, e2e.bootstrap_stage

        def bootstrap(*args, **kwargs):
            got = stage(*args, **kwargs)
            boot.update(got[2])
            return got

        with mock.patch.object(e2e, "bootstrap_stage", bootstrap):
            res = e2e.main(["all", "--smoke", "--out", out], device=dev,
                           sizes=sizes)
        files = {}
        for what, name in e2e.Report.FILES.items():
            with open(os.path.join(out, name)) as f:
                files[what] = json.load(f)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_phase
    launches = {"fwd": bdc.blocked_den_fwd_cuda.launches,
                "bwd": bdc.blocked_den_bwd_cuda.launches}
    rep, setup, sizes = res.report, res.setup, res.setup.sizes
    mc, e2e_out, ab, search = (res.base.model_cfg, files["e2e"],
                               files["bf16"], files["search"])
    table = search["table"]
    print(f"[e2e run] `main all --smoke` in {t_run:.1f} s (budget 420 s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in rep.seconds.items())
          + f" ({gpu})", flush=True)
    ref, lh, nv = E2E_REFERENCE, e2e_out["lhuc"], e2e_out["lhuc_noiv"]
    print("[e2e figures] smoke run (reference's full-scale run): "
          + ", ".join(f"{k} {e2e_out[k]} ({ref[k]})" for k in (
              "wer_first_pass_tg", "wer_4gram_rescore", "wer_rnnlm_rescore"))
          + f"; LHUC {lh['wer_before']} -> {lh['wer_after']} ({ref['lhuc']})"
          f", no-iv {nv['wer_before']} -> {nv['wer_after']} "
          f"({ref['lhuc_noiv']}); train objf {e2e_out['train']['objf_mmi']} "
          f"({ref['objf_mmi']}); A/B objf {ab['bfloat16']['objf_final']} / "
          f"{ab['float32']['objf_final']} ({ref['objf_final']}), WER "
          f"{ab['bfloat16']['wer']} / {ab['float32']['wer']} "
          f"({ref['ab_wer']}); table WER "
          + ", ".join(f"{k} {v['wer']} ({ref['table'][k]})"
                      for k, v in table.items()), flush=True)
    print(f"[e2e setup] tree {e2e_out['tree_pdfs']} pdfs (GMM ladder "
          f"{boot['gmm']:.1f} s, tree {boot['tree']:.1f} s), den "
          f"{e2e_out['den_states']} states "
          f"({type(setup.bundle.den_arrays).__name__}), HCLG "
          f"{e2e_out['hclg']['states']} states; model hidden "
          f"{mc.hidden_dim}, bottleneck {mc.bottleneck_dim}, "
          f"{1 + mc.num_tdnnf} layers, {e2e_out['train']['params']:,} "
          f"params; steps {rep.steps}, LHUC steps {rep.lhuc_steps}, valid "
          f"batches {rep.valid_batches}; launches fwd={launches['fwd']} "
          f"bwd={launches['bwd']}", flush=True)
    _check((mc.hidden_dim, mc.bottleneck_dim, mc.num_tdnnf) == (1536, 160, 14),
           "the 7q at full width: 15 layers, hidden 1,536, bottleneck 160")
    _check(isinstance(setup.bundle.den_arrays, BlockedDenGraph),
           "the run's den took the blocked form")
    # every key of the reference's three files
    _check(set(e2e_out) == E2E_KEYS["e2e"]
           and all(set(e2e_out[k]) == E2E_KEYS[k]
                   for k in ("corpus", "gmm", "ivectors", "train", "hclg",
                             "lhuc", "lhuc_noiv", "bf16_parity")),
           "e2e_flagship.json holds the reference's keys")
    _check(set(ab) == E2E_KEYS["bf16"]
           and all(set(ab[d]) == E2E_KEYS["dtype"]
                   for d in ("bfloat16", "float32")),
           "bf16_parity.json holds the reference's keys")
    _check(set(search) == E2E_KEYS["search"]
           and all(set(r) == E2E_KEYS["row"] for r in table.values()),
           "search_table_flagship.json holds the reference's keys")
    # finite objf, finite WER >= 0 (insertions can take it past 100)
    leaves = [(p, v) for what in files.values() for p, v in _walk(what)]
    objf = [np.asarray(v, float) for p, v in leaves if "objf" in p[-1]]
    wers = [v for p, v in leaves
            if p[-1] == "wer" or p[-1].startswith("wer_")]
    _check(len(objf) >= 12 and all(np.isfinite(a).all() and a.size
                                   for a in objf),
           "every objf finite")
    _check(len(wers) >= 14 and all(np.isfinite(v) and v >= 0 for v in wers),
           "every WER finite and >= 0")
    d = round(ab["bfloat16"]["wer"] - ab["float32"]["wer"], 2)
    _check(abs(ab["delta_wer"] - d) < 1e-9
           and e2e_out["bf16_parity"]["delta_wer"] == ab["delta_wer"],
           "delta_wer is the difference of the two WERs")
    # one launch of each kernel per step, the forward once per valid batch
    want = {"train": sizes.train_steps, "noiv": sizes.noiv_steps,
            "ab_bfloat16": sizes.ab_steps, "ab_float32": sizes.ab_steps,
            "supernet": sizes.pretrain_steps, "cv_1": sizes.cv_steps,
            "cv_11": sizes.cv_steps,
            **{f"child_{k}": sizes.child_steps for k in table}}
    _check(rep.steps == want, "every train_model run took its steps")
    n_steps = sum(rep.steps.values()) + rep.lhuc_steps
    _check(rep.lhuc_steps == 24 * (e2e_out["lhuc"]["speakers"]
                                   + e2e_out["lhuc_noiv"]["speakers"]),
           "24 LHUC steps a speaker")
    _check(launches == {"fwd": n_steps + rep.valid_batches, "bwd": n_steps},
           "each blocked kernel once per step, the forward once more per "
           "valid batch")
    _check(len(table) in (5, 6) and rep.valid_batches == 6 * len(table),
           "5 or 6 rows, each scored on 6 valid batches")
    _check(table["manual_baseline"]["params"] == e2e_out["train"]["params"]
           == count_params(res.base.state.params),
           "manual_baseline's params are stage 4's 7q's")
    _check(all(len(r["strides"]) == 14 for r in table.values()),
           "14 stride pairs a row")

    # one float32 step of the run's model and trainer on its den,
    # through the kernels and through the plain scan (phase 4's bars)
    _kernel_vs_plain_step(
        torch, dev, setup.bundle,
        e2e.model_config(setup.tree, setup.cfg, dtype="float32"),
        e2e.trainer_config(sizes.train_steps), 50, 64, "e2e")
    print(f"[e2e phase] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, setup, e2e_out


# ---- phase 15: the search experiments ----

# Phase 15's cuts, each printed beside the reference's figure, to fit the
# script's time limit (at the reference's sizes, and 300 utterances for
# (c), phase 15 took 294.7 s on the card; with twice these steps and
# decodes, 137.9-151.8 s): (a) the sanity check's (pretrain, cv-update,
# child) steps, the reference's 320 / 800 / 260; (b) the planted table's
# steps, its quick 120 / 200 / 150, and the test utterances each child
# decodes, 10 of its 60; (c) the WER pipeline's E2eWerSizes, a few
# hundred utterances with the reference's ladder and 400-leaf tree,
# training, RNNLM and search steps and test utterances cut
SANITY_SMOKE_STEPS = (40, 100, 30)
TABLE_SMOKE_CUT = dict(pretrain_steps=30, cv_steps=40, child_steps=30,
                       n_decode=10)
WER_SMOKE_SIZES = dict(n_test=4, num_utts=160, train_steps=40,
                       rnnlm_steps=30, pretrain_steps=20, cv_steps=20,
                       child_steps=20)
# the reference's files, whose keys phase 15's files must hold; sil's
# files share their keys with these (docs/ has no run of that variant)
SEARCH_DOCS = {"sanity": "search_sanity.json", "table": "search_table.json",
               "wer": "e2e_wer_hard.json",
               "wer_search": "search_table_e2e_hard.json"}


def _softmax_rows(alphas, rows, places: int, what: str):
    """The cv-update's alphas are finite, and each softmax row the file
    writes, rounded to ``places``, sums to 1 within its rounding."""
    _check(all(np.isfinite(a).all() for a in alphas),
           f"{what}: the cv-update's alphas are finite")
    rows = np.atleast_2d(np.asarray(rows, np.float64))
    tol = rows.shape[-1] * 0.5 * 10.0 ** -places + 1e-9
    _check(bool(np.all(np.abs(rows.sum(-1) - 1.0) <= tol)),
           f"{what}: each affine softmax row sums to 1 within {tol:.1e}")


def _hold_run(files: dict, docs: dict, report, launches, table_rows: dict,
              pairs_per_row: int, what: str):
    """What a search experiment's run must show at any size: its files'
    keys are the reference's (nested dicts too, every table row's), every
    objf finite, every WER finite and >= 0, each den kernel launched once
    per training, supernet, cv-update and child step and the forward once
    more per valid batch (steps from the run's metrics), and
    ``pairs_per_row`` stride pairs in each table row."""
    for name, got in files.items():
        ref = docs[name]
        _check(set(got) == set(ref), f"{what}: {name} holds the reference's "
               "keys")
        for k, v in ref.items():
            if isinstance(v, dict) and k not in ("table", "child_table"):
                _check(set(got[k]) == set(v), f"{what}: {name}[{k}] keys")
    for name, rows in table_rows.items():
        ref_row = set(next(iter(docs[name].get(
            "table", docs[name].get("child_table", {})).values())))
        _check(all(set(r) == ref_row for r in rows.values()),
               f"{what}: every {name} row holds the reference's keys")
        _check(all(len(r.get("strides", r.get("pairs"))) == pairs_per_row
                   for r in rows.values()),
               f"{what}: {pairs_per_row} stride pairs a row")
    leaves = [(p, v) for f in files.values() for p, v in _walk(f)]
    objf = [v for p, v in leaves if "objf" in p[-1] and p[-1] != "dev_objf_gap"]
    wers = [v for p, v in leaves if p[-1] == "wer" or p[-1].startswith("wer_")]
    _check(objf and all(np.isfinite(v) for v in objf),
           f"{what}: every objf finite")
    _check(all(np.isfinite(v) and v >= 0 for v in wers),
           f"{what}: every WER finite and >= 0")
    n_steps = sum(report.steps.values())
    _check(launches == (n_steps + report.valid_batches, n_steps),
           f"{what}: each den kernel once per step, the forward once more "
           "per valid batch")
    print(f"[{what}] steps {report.steps}, valid batches "
          f"{report.valid_batches}; launches fwd={launches[0]} "
          f"bwd={launches[1]}; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in report.seconds.items()),
          flush=True)


def _search_experiments_phase(torch, dev, gpu):
    """Phase 15: the three search tools in this process, each into a
    fresh temporary directory.  (a) ``search_sanity_planted.main`` at
    ``SANITY_SMOKE_STEPS`` (phase 5 holds the dense pair at its den's
    shape); (b) ``search_planted_table.main(quick=True)`` cut by
    ``TABLE_SMOKE_CUT`` and the blocked pair on its den at B = 48,
    T = 24; (c) ``e2e_wer_pipeline.main(["all", "--variant", "sil"])`` at
    ``WER_SMOKE_SIZES``.  Each run is held to ``_hold_run``, its den's
    form, its arithmetic and one float32 step against the plain scan.
    Returns (dense launches, blocked launches, the blocked pair's fields
    at B = 48)."""
    import tempfile

    from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph
    from tdnnf_nas_torch.models import count_params, init_model
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.tools import e2e_wer_pipeline as wer
    from tdnnf_nas_torch.tools import search_planted_table as spt
    from tdnnf_nas_torch.tools import search_sanity_planted as ssp
    from tdnnf_nas_torch.train import ChainObjectiveConfig, TrainerConfig

    docs = {k: json.load(open(os.path.join(REPO, "docs", v)))
            for k, v in SEARCH_DOCS.items()}
    torch.cuda.empty_cache()
    tc32 = TrainerConfig(objective=ChainObjectiveConfig())

    def manual_params(mc):
        return count_params(init_model(mc, torch.Generator().manual_seed(0),
                                       device="cpu")[0])

    # ---- (a) the sanity check: dense den, S = 16 ----
    t0 = time.perf_counter()
    ddc.dense_den_fwd_cuda.launches = ddc.dense_den_bwd_cuda.launches = 0
    print("[sanity] steps cut from the reference's: pretrain, cv-update, "
          f"child {SANITY_SMOKE_STEPS} (320, 800, 260)", flush=True)
    with tempfile.TemporaryDirectory() as out:
        res = ssp.main(*SANITY_SMOKE_STEPS, out=out, device=dev)
        with open(os.path.join(out, ssp.FILE)) as f:
            sanity = json.load(f)
    torch.cuda.synchronize()
    dense_launches = _dense_launches(ddc)
    t_a = time.perf_counter() - t0
    bundle = res.bundle
    _check(isinstance(bundle.den_arrays, DenGraphArrays)
           and bundle.den_fsa is None and bundle.den.num_states == 16,
           "sanity: a dense den of 16 states")
    _hold_run({"sanity": sanity}, docs, res.report, dense_launches,
              {"sanity": sanity["child_table"]}, 1, "sanity")
    table = sanity["child_table"]
    _check(sanity["dev_objf_gap"] == round(
        table["searched_top1"]["dev_objf"] - table["no_lookahead"]["dev_objf"],
        4), "sanity: dev_objf_gap is the difference of the dev objfs")
    _check(sanity["planted_reach_found"] == bool(
        sanity["top1_affine_stride"] in (2, 3)
        and sanity["reachable_mass"] > 0.8),
        "sanity: planted_reach_found is its own arithmetic")
    _softmax_rows(res.alphas, sanity["affine_softmax"], 4, "sanity")
    ref = docs["sanity"]
    print(f"[sanity] {t_a:.1f} s ({gpu}): affine softmax "
          f"{sanity['affine_softmax']} ({ref['affine_softmax']}), reachable "
          f"mass {sanity['reachable_mass']} ({ref['reachable_mass']}), "
          f"found {sanity['planted_reach_found']} "
          f"({ref['planted_reach_found']}), entropies after the cv-update "
          f"{sanity['alpha_entropy_after_cvupdate']} "
          f"({ref['alpha_entropy_after_cvupdate']}), dev objf gap "
          f"{sanity['dev_objf_gap']} ({ref['dev_objf_gap']}); reference's "
          "figures in brackets", flush=True)
    _kernel_vs_plain_step(torch, dev, bundle, res.base, tc32, ssp.CHUNK,
                          ssp.BATCH, "sanity")
    del res, bundle

    # ---- (b) the planted table at its quick sizes: blocked den ----
    t0 = time.perf_counter()
    _reset_blocked(bdc)
    quick = spt.TableSizes.preset(True)
    sizes = dataclasses.replace(quick, **TABLE_SMOKE_CUT)
    was = dict(dataclasses.asdict(quick), n_decode=quick.n_test)
    print("[table] sizes cut from the quick preset's: " + ", ".join(
        f"{k} {getattr(sizes, k)} (quick {was[k]})" for k in TABLE_SMOKE_CUT),
        flush=True)
    tree_s = {}
    with tempfile.TemporaryDirectory() as out, mock.patch.object(
            spt, "build_clustered_triphone_tree",
            _timed(spt.build_clustered_triphone_tree, tree_s, "table")):
        res = spt.main(quick=True, out=out, device=dev, sizes=sizes)
        with open(os.path.join(out, spt.FILE)) as f:
            tab = json.load(f)
    torch.cuda.synchronize()
    blocked_launches = _blocked_launches(bdc)
    t_b = time.perf_counter() - t0
    bundle, mc = res.setup.bundle, res.model_cfg
    _check(isinstance(bundle.den_arrays, BlockedDenGraph),
           "table: the den took the blocked form")
    _hold_run({"table": tab}, docs, res.report, blocked_launches,
              {"table": tab["table"]}, 5, "table")
    _check(tab["diagnosis_round3"] == docs["table"]["diagnosis_round3"],
           "table: diagnosis_round3 verbatim")
    _check(all(r["lookahead_reach"] == 1 + sum(a for _, a in r["strides"]) + 2
               for r in tab["table"].values()),
           "table: lookahead_reach is its own arithmetic")
    _check(tab["table"]["manual_baseline"]["params"] == manual_params(mc),
           "table: the manual row's params are the manual config's")
    _softmax_rows(res.search.alphas, tab["affine_softmax"], 3, "table")
    ref = docs["table"]
    print(f"[table] {t_b:.1f} s ({gpu}): tree {res.setup.tree.num_pdfs} pdfs "
          f"in {tree_s['table']:.1f} s, "
          f"den {bundle.den_fsa.num_states} states; alpha entropy "
          f"{tab['alpha_entropy']} ({ref['alpha_entropy']}); WER "
          + ", ".join(f"{k} {v['wer']} ({ref['table'][k]['wer']})"
                      for k, v in tab["table"].items())
          + "; params " + ", ".join(f"{k} {v['params']:,}"
                                    for k, v in tab["table"].items())
          + "; reference's full-scale figures in brackets", flush=True)
    blocked = _blocked_check(torch, dev, gpu, den_on_device(bundle, dev),
                             res.setup.tree.num_pdfs, spt.SEARCH_BATCH,
                             t=spt.CHUNK)
    _kernel_vs_plain_step(torch, dev, bundle, mc.replace(
        compute_dtype="float32"), tc32, spt.CHUNK, spt.SEARCH_BATCH, "table")
    del res, bundle

    # ---- (c) the WER pipeline, silence variant, cut to fit ----
    t0 = time.perf_counter()
    sizes = dataclasses.replace(wer.E2eWerSizes.full(), **WER_SMOKE_SIZES)
    full = wer.E2eWerSizes.full()
    print("[wer] sizes cut from the reference's: " + ", ".join(
        f"{k} {getattr(sizes, k)} (reference {getattr(full, k)})"
        for k in WER_SMOKE_SIZES), flush=True)
    n0 = _blocked_launches(bdc)
    with tempfile.TemporaryDirectory() as out, mock.patch.object(
            wer, "build_clustered_triphone_tree",
            _timed(wer.build_clustered_triphone_tree, tree_s, "wer")):
        res = wer.main(["all", "--variant", "sil", "--out", out], device=dev,
                       sizes=sizes)
        names = wer.file_names("sil")
        files = {}
        for what, key in (("e2e", "wer"), ("search", "wer_search")):
            with open(os.path.join(out, names[what])) as f:
                files[key] = json.load(f)
    torch.cuda.synchronize()
    n1 = _blocked_launches(bdc)
    launches = tuple(b - a for a, b in zip(n0, n1))
    t_c = time.perf_counter() - t0
    bundle, mc = res.setup.bundle, res.base.model_cfg
    e2e, stab = files["wer"], files["wer_search"]
    _check(isinstance(bundle.den_arrays, BlockedDenGraph),
           "wer: the den took the blocked form")
    _check(e2e["silence"] is True and res.setup.cfg.silence_prob > 0,
           "wer: the silence corpus and its HCLG")
    _hold_run(files, docs, res.report, launches,
              {"wer_search": stab["table"]}, 5, "wer")
    _check(stab["table"]["manual_baseline"]["params"] == manual_params(mc),
           "wer: the manual row's params are the manual config's")
    ref, ref_s = docs["wer"], docs["wer_search"]
    print(f"[wer] {t_c:.1f} s ({gpu}): tree {e2e['tree_pdfs']} pdfs in "
          f"{tree_s['wer']:.1f} s, den "
          f"{e2e['den_states']} states, HCLG {e2e['hclg_states']} states; "
          f"objf {e2e['train_objf_mmi']}; WER first pass "
          f"{e2e['wer_first_pass_tg']}, 4-gram {e2e['wer_4gram_rescore']}, "
          f"RNNLM {e2e['wer_rnnlm_rescore']}; table WER "
          + ", ".join(f"{k} {v['wer']}" for k, v in stab["table"].items())
          + f" (the hard variant's full run: first pass "
          f"{ref['wer_first_pass_tg']}, table "
          + ", ".join(f"{k} {v['wer']}" for k, v in ref_s["table"].items())
          + ")", flush=True)
    _kernel_vs_plain_step(torch, dev, bundle, mc.replace(
        compute_dtype="float32"), tc32, spt.CHUNK, spt.SEARCH_BATCH, "wer")
    blocked_launches = tuple(a + b for a, b in zip(blocked_launches, launches))
    print(f"[phase 15] (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) {t_c:.1f} s "
          f"(budget 240 s in all)", flush=True)
    return dense_launches, blocked_launches, blocked


# ---- the host worker: phase 12's and phase 16's host set-ups ----

# The worker's BLAS, OpenMP and torch threads: the main process's
# launch-bound phases keep the other cores
HOST_WORKER_THREADS = 2
# The longest a phase waits for one of the worker's files: its longest
# set-up, phase 12's, took 79.3 s on the card's host since the tree
# clustering is vectorised (114.6-138.1 s before)
HOST_WORKER_WAIT_S = 400.0


def _host_worker_main(work: str) -> int:
    """The host worker, ``python3 chip_smoke.py --host-worker DIR``,
    started before phase 0 with no card visible (``CUDA_VISIBLE_DEVICES``
    empty) and its threads capped.  It builds on the CPU, in the order
    the phases need them: phase 1's set-up (the flagship corpus from its
    seed, the left-2 tree and the blocked den), phase 10's CPU run of the
    GMM ladder, phase 12's set-up (the +-1 tree and ``prepare_data``'s
    factored den, on phase 1's corpus) and phase 16's
    (``context_compare``'s and ``wpd_compare``'s corpora, trees, dens and
    HCLGs at their cut sizes), and writes each as DIR/<name>.pkl, through
    a temporary name and a rename, with its seconds."""
    import pickle

    import torch

    sys.path.insert(0, REPO)
    from tdnnf_nas_torch.tools import context_compare as cc
    from tdnnf_nas_torch.tools import wpd_compare as wpd

    torch.set_num_threads(HOST_WORKER_THREADS)
    _check(not torch.cuda.is_available(), "the host worker sees no card")

    def put(name: str, payload: dict, t0: float) -> None:
        payload["seconds"] = time.perf_counter() - t0
        tmp = os.path.join(work, f".{name}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(work, f"{name}.pkl"))
        print(f"[host worker] {name}: {payload['seconds']:.1f} s", flush=True)

    t0 = time.perf_counter()
    flagship = _flagship_host_setup()
    put("flagship", flagship, t0)
    t0 = time.perf_counter()
    put("tri5_7d_cpu_ladder", _tri5_7d_cpu_ladder(), t0)
    t0 = time.perf_counter()
    utts, phone_seqs = flagship["utts"], flagship["phone_seqs"]
    put("pm1_factored", _pm1_factored_setup(utts, phone_seqs,
                                            flagship["topo"]), t0)
    del flagship, utts, phone_seqs
    t0 = time.perf_counter()
    put("context_compare", {"world": cc.build_world(
        CC_SMOKE_MODE, _cc_sizes(cc))}, t0)
    t0 = time.perf_counter()
    put("wpd_compare", {"world": wpd.build_world(_wpd_sizes(wpd))}, t0)
    return 0


class _HostWorker:
    """The host worker process and the files it hands over.  ``take(name,
    what)`` waits for DIR/<name>.pkl at the start of the phase that needs
    it, prints the wait and returns the pickle; if the worker exits first,
    or the file is not there within ``HOST_WORKER_WAIT_S``, the phase
    fails naming it, with the end of the worker's log.  ``finish()``
    checks its exit code after the last file; ``close()`` stops it and
    removes DIR."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_host_")
        self.log_path = os.path.join(self.dir, "worker.log")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                  "OPENBLAS_NUM_THREADS"):
            env[k] = str(HOST_WORKER_THREADS)
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--host-worker",
                 self.dir], stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=REPO)
        self.t0 = time.perf_counter()
        print(f"[host worker] started: pid {self.proc.pid}, no card, "
              f"{HOST_WORKER_THREADS} threads", flush=True)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def take(self, name: str, what: str):
        import pickle

        path = os.path.join(self.dir, f"{name}.pkl")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            rc = self.proc.poll()
            wait = time.perf_counter() - t0
            if os.path.exists(path):
                break
            if rc is not None or wait > HOST_WORKER_WAIT_S:
                tail = "\n".join(self.log().splitlines()[-30:])
                why = (f"exited with code {rc}" if rc is not None else
                       f"was still running after {wait:.0f} s")
                raise RuntimeError(
                    f"the host worker {why} before writing {name}.pkl "
                    f"({what}); its log ends:\n{tail}")
            time.sleep(0.2)
        wait = time.perf_counter() - t0
        with open(path, "rb") as f:
            out = pickle.load(f)
        print(f"[host worker] {what}: waited {wait:.1f} s (built in "
              f"{out['seconds']:.1f} s; {time.perf_counter() - self.t0:.1f} "
              "s since the worker started)", flush=True)
        return out

    def finish(self) -> None:
        rc = self.proc.wait(timeout=120)
        _check(rc == 0, f"the host worker exited with code {rc}")
        print("[host worker] log:\n" + self.log().rstrip(), flush=True)

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


# ---- phase 16: the comparison drivers ----

# Phase 16's cuts, each printed beside the reference's figure, to fit the
# script's time limit: (a) the no-i-vector model's steps (the reference's
# 1,000) and (b) the AM's, the RNNLM's steps and the extra text (1,600,
# 48,000, 700,000), each on the first COMPARE_TEST_UTTS of phase 14's
# test utterances (the reference's 200; at 10, (a) took 61.7 s, 600 LHUC
# steps at ~70 ms, and at 5 (a) and (b) 69.0 s, so 2 keep the script
# clear of its limit on a slow host); (c)
# context_compare's symhard run, utterances, test utterances and steps a
# contender (720, 60, 800); (d) wpd_compare's (360, 50, 500); (e)
# wer_synthetic at the reference's sizes: after 40 steps its model's
# exact 10-best search took 3-10 s an utterance on the CPU, after 300
# 0.1 s
COMPARE_TEST_UTTS = 2
LHUC_SMOKE = dict(noiv_steps=40)
FIGHT_SMOKE = dict(am_steps=40, rnnlm_steps=30, extra_text=2000)
CC_SMOKE_MODE = "symhard"
CC_SMOKE = dict(num_utts=200, n_test=20, steps=30)
WPD_SMOKE = dict(num_utts=150, n_test=20, steps=30)
COMPARE_DOCS = {"lhuc": "lhuc_noiv_reg.json", "fight": "rnnlm_rescore.json",
                "cc": "context_compare_symhard.json",
                "wpd": "wpd_compare.json", "ws": "wer_synthetic.json"}


def _cc_sizes(cc):
    return dataclasses.replace(cc.CompareSizes.full(), **CC_SMOKE)


def _wpd_sizes(wpd):
    return dataclasses.replace(wpd.WpdSizes.full(), **WPD_SMOKE)


def _print_cut(what: str, cut: dict, full: dict) -> None:
    print(f"[{what}] cut from the reference's: " + ", ".join(
        f"{k} {v} (reference {full[k]})" for k, v in cut.items()),
        flush=True)


def _hold_file(got: dict, ref: dict, what: str) -> None:
    """A comparison driver's file at any size: the reference file's keys
    at every level (table rows, variants, sweeps), every objf finite,
    every WER finite and >= 0."""
    def keys(g, r, path):
        _check(set(g) == set(r), f"{what}: {'/'.join(path) or 'the file'} "
               "holds the reference's keys")
        for k, v in r.items():
            if isinstance(v, dict):
                keys(g[k], v, path + (k,))

    keys(got, ref, ())
    leaves = list(_walk(got))
    objf = [v for p, v in leaves if "objf" in p[-1]]
    wers = [v for p, v in leaves
            if p[-1] == "wer" or p[-1].startswith("wer_")
            or p[-1].endswith("_wer") or p[0].startswith("sweep_")]
    _check(all(np.isfinite(v) for v in objf), f"{what}: every objf finite")
    _check(wers and all(np.isfinite(v) and v >= 0 for v in wers),
           f"{what}: every WER finite and >= 0")


def _compare_dens(world, what: str):
    """Every contender's den is blocked, with the wildcard term exactly
    for ``pm1``."""
    from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph

    for name, host in world.hosts.items():
        den = host.bundle.den_arrays
        _check(isinstance(den, BlockedDenGraph)
               and (den.bcast_sel is not None) == (name == "pm1"),
               f"{what}: {name}'s den is blocked, with the wildcard term "
               "exactly for pm1")


def _comparison_drivers_phase(torch, dev, gpu, host_worker, e2e_setup,
                              e2e_file: dict):
    """Phase 16: the five comparison drivers' ``main`` in this process,
    each into a fresh temporary directory.  (a) ``lhuc_regularized`` and
    (b) ``rnnlm_fair_fight`` on phase 14's set-up, its first
    ``COMPARE_TEST_UTTS`` test utterances (no set-up rebuilt; (a)
    patches a copy of phase 14's ``e2e_flagship.json``); (c)
    ``context_compare --mode symhard`` and (d) ``wpd_compare`` on the
    host worker's worlds, then the blocked pair against its plain
    version on (c)'s ``pm1`` den (wildcard term) at B = 48, T = 40; (e)
    ``wer_synthetic``, then the dense pair against its plain version on
    its den at B = 16, T = 20.  Each run is held to ``_hold_file``, its
    arithmetic, its dens' forms and its kernel launches (once per
    training and LHUC step, the forward once more per valid batch);
    (c) and (e) each take one float32 step through the kernels against
    the plain scan.  Returns (blocked launches, dense launches, the
    blocked pair's fields at B = 48, T = 40, the dense pair's at B = 16,
    T = 20)."""
    import tempfile

    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.tools import context_compare as cc
    from tdnnf_nas_torch.tools import lhuc_regularized as lr
    from tdnnf_nas_torch.tools import rnnlm_fair_fight as rf
    from tdnnf_nas_torch.tools import wer_synthetic as ws
    from tdnnf_nas_torch.tools import wpd_compare as wpd
    from tdnnf_nas_torch.train import ChainObjectiveConfig, TrainerConfig

    docs = {k: json.load(open(os.path.join(REPO, "docs", v)))
            for k, v in COMPARE_DOCS.items()}
    torch.cuda.empty_cache()
    tc32 = TrainerConfig(objective=ChainObjectiveConfig())
    secs = {}
    n_test = COMPARE_TEST_UTTS
    print(f"[lhuc, fight] on the first {n_test} of phase 14's "
          f"{len(e2e_setup.test)} test utterances (the reference's "
          f"{lr.E2eSizes.full().n_test})", flush=True)
    e2e_setup = dataclasses.replace(e2e_setup, test=e2e_setup.test[:n_test],
                                    iv_test=e2e_setup.iv_test[:n_test])

    def run(what, fn):
        """fn(out) in a fresh directory, with its blocked and dense
        launches and seconds: (result, its file, the other files it left
        there, blocked, dense)."""
        t0 = time.perf_counter()
        b0, d0 = _blocked_launches(bdc), _dense_launches(ddc)
        with tempfile.TemporaryDirectory() as out:
            res, name = fn(out)
            with open(os.path.join(out, name)) as f:
                got = json.load(f)
            extra = {n: json.load(open(os.path.join(out, n)))
                     for n in os.listdir(out) if n != name}
        torch.cuda.synchronize()
        blocked = tuple(b - a for a, b in zip(b0, _blocked_launches(bdc)))
        dense = tuple(b - a for a, b in zip(d0, _dense_launches(ddc)))
        secs[what] = time.perf_counter() - t0
        print(f"[{what}] {secs[what]:.1f} s ({gpu}); stage seconds "
              + ", ".join(f"{k} {v:.1f}"
                          for k, v in res.report.seconds.items()),
              flush=True)
        return res, got, extra, blocked, dense

    def launches_per_step(what, got, want):
        _check(got == want, f"{what}: each den kernel once per step, the "
               "forward once more per valid batch (launches "
               f"{got}, steps and valid batches give {want})")

    # ---- (a) the LHUC sweep on phase 14's set-up ----
    _print_cut("lhuc", LHUC_SMOKE, dataclasses.asdict(lr.LhucSizes()))

    def lhuc(out):
        with open(os.path.join(out, lr.E2E_FILE), "w") as f:
            json.dump(e2e_file, f)
        return lr.main(["--out", out], device=dev,
                       sizes=lr.LhucSizes(**LHUC_SMOKE),
                       setup=e2e_setup), lr.FILE

    res, got, extra, blocked, dense = run("lhuc", lhuc)
    _hold_file(got, docs["lhuc"], "lhuc")
    rows = got["variants"]
    _check(got["best_variant"] == min(
        rows, key=lambda k: (rows[k]["wer_after"], list(rows).index(k))),
        "lhuc: best_variant is the first of least wer_after")
    n_lhuc = sum(r["num_steps"] * r["speakers"] for r in rows.values())
    _check(res.report.lhuc_steps == n_lhuc and res.report.steps == {
        "noiv": LHUC_SMOKE["noiv_steps"]},
        "lhuc: every no-iv step and each speaker's LHUC steps taken")
    n = res.report.steps["noiv"] + res.report.lhuc_steps
    launches_per_step("lhuc", blocked, (n, n))
    patched = extra[lr.E2E_FILE]["lhuc_noiv"]
    _check(res.patched and patched["regularization"] == got["best_variant"]
           and patched["wer_after"] == rows[got["best_variant"]]["wer_after"],
           "lhuc: e2e_flagship.json's lhuc_noiv row is the best variant's")
    ref = docs["lhuc"]
    print(f"[lhuc] unadapted {got['wer_unadapted_full']} "
          f"({ref['wer_unadapted_full']}); after: " + ", ".join(
              f"{k} {v['wer_after']} ({ref['variants'][k]['wer_after']})"
              for k, v in rows.items())
          + f"; best {got['best_variant']} ({ref['best_variant']}); "
          f"{rows['unregularized_24']['speakers']} speakers; reference's "
          "full-scale figures in brackets", flush=True)
    blocked_total = blocked

    # ---- (b) the RNNLM fair fight on phase 14's set-up ----
    _print_cut("fight", FIGHT_SMOKE, dict(
        dataclasses.asdict(rf.FairFightSizes()), rnnlm_steps=rf.RNNLM_STEPS,
        extra_text=rf.EXTRA_TEXT))
    res, got, _, blocked, dense = run("fight", lambda out: (rf.main(
        ["--out", out, "--rnnlm-steps", str(FIGHT_SMOKE["rnnlm_steps"]),
         "--extra-text", str(FIGHT_SMOKE["extra_text"])], device=dev,
        sizes=rf.FairFightSizes(am_steps=FIGHT_SMOKE["am_steps"]),
        setup=e2e_setup), rf.FILE))
    _hold_file(got, docs["fight"], "fight")
    dev_half = got["sweep_dev_half"]
    choice = str(got["interp_weight_dev_choice"])
    _check(list(dev_half) == [str(w) for w in rf.INTERP_WEIGHTS]
           and dev_half[choice] == min(dev_half.values())
           and got["wer_rnnlm_eval_at_dev_weight"]
           == got["sweep_eval_half"][choice]
           and got["lattice_rescore"]["interp_weight"]
           == got["interp_weight_dev_choice"],
           "fight: the weight is the dev half's least WER, its eval figure "
           "and the lattice rescoring's")
    _check(got["lattice_rescore"]["num_lattices"] == n_test
           and got["lm_text"]["fisher_analogue_extra"]
           == FIGHT_SMOKE["extra_text"]
           and got["rnnlm"]["steps"] == FIGHT_SMOKE["rnnlm_steps"]
           and res.report.steps == {"am": FIGHT_SMOKE["am_steps"]},
           "fight: its lattices, extra text, RNNLM and AM steps")
    launches_per_step("fight", blocked, (FIGHT_SMOKE["am_steps"],) * 2)
    ref = docs["fight"]
    print("[fight] " + ", ".join(
        f"{k} {got[k]} ({ref[k]})" for k in (
            "wer_first_pass_tg", "wer_4gram_small_nbest", "wer_4gram_nbest",
            "oracle_nbest_wer", "interp_weight_dev_choice",
            "wer_rnnlm_eval_at_dev_weight"))
          + f"; ppl held-out {got['rnnlm']['ppl_heldout_text']} "
          f"({ref['rnnlm']['ppl_heldout_text']}); lattice rescoring "
          f"{got['lattice_rescore']['seconds_per_lattice']} s a lattice "
          f"({ref['lattice_rescore']['seconds_per_lattice']} on the TPU "
          f"host); lattice_nbest over {n_test} lattices "
          f"{res.nbest_seconds:.1f} s; reference's full-scale figures in "
          "brackets", flush=True)
    blocked_total = tuple(a + b for a, b in zip(blocked_total, blocked))

    # ---- (c) the context comparison, symhard, on the worker's world ----
    world = host_worker.take("context_compare", "phase 16's context_compare "
                             "world")["world"]
    sizes = _cc_sizes(cc)
    _print_cut("context", CC_SMOKE,
               dataclasses.asdict(cc.CompareSizes.full()))
    _compare_dens(world, "context")
    res, got, _, blocked, dense = run("context", lambda out: (cc.main(
        ["--mode", CC_SMOKE_MODE, "--out", out], device=dev, sizes=sizes,
        world=world), cc.FILES[CC_SMOKE_MODE]))
    _hold_file(got, docs["cc"], "context")
    _check(res.report.steps == {n: sizes.steps for n in cc.CONTENDERS}
           and res.report.valid_batches == 6 * len(cc.CONTENDERS),
           "context: every contender's steps and 6 valid batches")
    n = sum(res.report.steps.values())
    launches_per_step("context", blocked, (n + res.report.valid_batches, n))
    ref = docs["cc"]["table"]
    print("[context] " + "; ".join(
        f"{k}: " + ", ".join(f"{f} {v[f]} ({ref[k][f]})" for f in (
            "pdfs", "cluster_ll_per_frame", "den_states", "den_arcs",
            "hclg_states", "dev_objf", "wer"))
        for k, v in got["table"].items())
          + "; reference's full-scale figures in brackets", flush=True)
    blocked_total = tuple(a + b for a, b in zip(blocked_total, blocked))
    pm1 = world.hosts["pm1"]
    ctx = _blocked_check(torch, dev, gpu, den_on_device(pm1.bundle, dev),
                         pm1.tree.num_pdfs, 48, t=40)
    _kernel_vs_plain_step(torch, dev, pm1.bundle, cc.model_config(
        pm1.tree.num_pdfs).replace(compute_dtype="float32"), tc32, 40, 48,
        "context pm1")
    del world, pm1

    # ---- (d) word-position-marked phones, on the worker's world ----
    world = host_worker.take("wpd_compare", "phase 16's wpd_compare "
                             "world")["world"]
    host_worker.finish()
    sizes = _wpd_sizes(wpd)
    _print_cut("wpd", WPD_SMOKE, dataclasses.asdict(wpd.WpdSizes.full()))
    _compare_dens(world, "wpd")
    res, got, _, blocked, dense = run("wpd", lambda out: (wpd.main(
        ["--out", out], device=dev, sizes=sizes, world=world), wpd.FILE))
    _hold_file(got, docs["wpd"], "wpd")
    _check(got["corpus"] == docs["wpd"]["corpus"],
           "wpd: the corpus string verbatim")
    _check(got["table"]["left1_wpd"]["pdfs"] > 0
           and world.hosts["left1_wpd"].bundle.num_phones
           == 4 * world.hosts["left1"].bundle.num_phones,
           "wpd: the marked contender's phones are the 4 marks of each")
    n = sum(res.report.steps.values())
    _check(res.report.valid_batches == 4 * len(wpd.CONTENDERS),
           "wpd: 4 valid batches a contender")
    launches_per_step("wpd", blocked, (n + res.report.valid_batches, n))
    ref = docs["wpd"]["table"]
    print("[wpd] " + "; ".join(
        f"{k}: " + ", ".join(f"{f} {v[f]} ({ref[k][f]})" for f in (
            "pdfs", "den_states", "dev_objf", "wer"))
        for k, v in got["table"].items())
          + "; reference's full-scale figures in brackets", flush=True)
    blocked_total = tuple(a + b for a, b in zip(blocked_total, blocked))
    del world

    # ---- (e) the WER demo: the dense den ----
    print("[ws] at the reference's sizes: 160 utterances, 300 steps, 300 "
          "RNNLM steps", flush=True)
    res, got, _, blocked, dense = run("ws", lambda out: (ws.main(
        ["--out", out], device=dev), ws.FILE))
    _hold_file(got, docs["ws"], "ws")
    bundle = res.bundle
    _check(isinstance(bundle.den_arrays, DenGraphArrays)
           and bundle.den_fsa is None, "ws: the dense den")
    _check(got["num_utts"] > 0 and res.report.steps == {"train": 300},
           "ws: 300 steps and a scored dev set")
    _check(blocked == (0, 0), "ws: no blocked launch")
    launches_per_step("ws", dense, (300, 300))
    ref = docs["ws"]
    print("[ws] " + ", ".join(f"{k} {got[k]:.4g} ({ref[k]:.4g})"
                              for k in ref)
          + "; reference's figures in brackets", flush=True)
    dense_total = dense
    wsd = _dense_check(torch, dev, gpu, den_on_device(bundle, dev),
                       res.model_cfg.num_pdfs, ws.BATCH, ws.CHUNK)
    _kernel_vs_plain_step(torch, dev, bundle, res.model_cfg.replace(
        compute_dtype="float32"), tc32, ws.CHUNK, ws.BATCH, "ws")
    print("[phase 16] " + ", ".join(f"{k} {v:.1f} s"
                                    for k, v in secs.items()), flush=True)
    return blocked_total, dense_total, ctx, wsd


# Phase 17's cuts: rounds and calls per figure, the train steps of
# bench_triphone_den, bench_sparse_decode's vocabulary and test set, and
# bench_scaling's gloo ranks on the one card
TOOLS_ROUNDS, TOOLS_CALLS, TOOLS_STEPS = 2, 3, 5
SPARSE_SMOKE = dict(vocab_size=1000, n_train_sents=5000, n_test=4)
SCALING_SMOKE_RANKS = 2


@contextlib.contextmanager
def _tool(name: str):
    """Names the tool that fails, with its seconds on success."""
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        raise RuntimeError(f"tool {name} failed: {e!r}") from e
    print(f"[tools] {name} ok {time.perf_counter() - t0:.1f} s", flush=True)


def _finite(res: dict, keys, what: str) -> None:
    _check(all(np.isfinite(res[k]) and res[k] > 0 for k in keys),
           f"{what}: finite positive {', '.join(keys)}")


def _tools_phase(torch, dev, gpu, tree, bundle):
    """17: the six profile and bench tools at cut sizes on the card, each
    held to its keys, its host figures and its den's kernels; rows 2-3 on
    phase 1's production set-up (``tree``, ``bundle``).  Returns the
    kernels' launches of the phase: ((blocked fwd, bwd), (dense fwd,
    bwd))."""
    import tempfile

    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.tools import (bench_dense_den, bench_scaling,
                                       bench_sparse_decode,
                                       bench_triphone_den,
                                       profile_components, profile_den)

    for fn in (bdc.blocked_den_fwd_cuda, bdc.blocked_den_bwd_cuda,
               ddc.dense_den_fwd_cuda, ddc.dense_den_bwd_cuda):
        fn.launches = 0
    timing = dict(n=TOOLS_CALLS, rounds=TOOLS_ROUNDS, device=dev)
    with tempfile.TemporaryDirectory() as out:
        with _tool("profile_components"):
            res = profile_components.run(out, **timing)
            _finite(res, profile_components.KEYS, "profile_components")
            _check(res["den_states"] == res["tree_pdfs"] == 2208,
                   "profile_components: the biphone den, S = 2,208")
            print("[tools] profile_components ms: " + ", ".join(
                f"{k} {res[k]:.3f}" for k in profile_components.KEYS)
                + f" ({gpu})", flush=True)
        with _tool("profile_den"):
            res = profile_den.run(out, bundle=bundle, tree=tree, **timing)
            _finite(res, profile_den.KEYS, "profile_den")
            _check(res["den_states"] == 10271, "profile_den: 10,271 states")
            print("[tools] profile_den ms: " + ", ".join(
                f"{k} {res[k]:.3f}" for k in profile_den.KEYS)
                + f" ({gpu})", flush=True)
        with _tool("bench_triphone_den"):
            res = bench_triphone_den.run(out, TOOLS_STEPS, bundle=bundle,
                                         tree=tree, rounds=TOOLS_ROUNDS,
                                         reps=TOOLS_CALLS, device=dev)
            _check(set(bench_triphone_den.KEYS) <= set(res),
                   "bench_triphone_den: the reference's keys")
            _check((res["num_pdfs"], res["den_states"], res["params"])
                   == (6034, 10271, 18_751_248),
                   "bench_triphone_den: 6,034 pdfs, 10,271 states, "
                   "18,751,248 params")
            _finite(res, ("den_fwd_grad_ms", "train_step_ms"),
                    "bench_triphone_den")
            _check(np.isfinite(res["objf_mmi"]), "bench_triphone_den: objf")
            print(f"[tools] bench_triphone_den: den fwd+grad "
                  f"{res['den_fwd_grad_ms']} ms, step {res['train_step_ms']}"
                  f" ms over {TOOLS_STEPS} steps, objf {res['objf_mmi']}, "
                  f"positions {res['den_positions']}, K "
                  f"{res['den_in_degree_K']}, LM states "
                  f"{res['phone_lm_states']} ({gpu})", flush=True)
        with _tool("bench_sparse_decode"):
            _print_cut("bench_sparse_decode", SPARSE_SMOKE,
                       bench_sparse_decode.PRESETS["5k"])
            res, hyps = bench_sparse_decode.run(out, **SPARSE_SMOKE)
            _check(len(hyps) == SPARSE_SMOKE["n_test"]
                   and np.isfinite(res["wer"])
                   and res["native_python_mismatches"] == 0,
                   "bench_sparse_decode: finite WER, C++ equals numpy")
            print(f"[tools] bench_sparse_decode: HCLG {res['graph_states']} "
                  f"states, {res['graph_arcs']} arcs; WER {res['wer']:.2f}; "
                  f"RTF {res['rtf']} (numpy {res['rtf_python']}); lattices "
                  f"{res['lattice_bestpath_match']}", flush=True)
        with _tool("bench_scaling"):
            res = bench_scaling.run(out, max_ranks=SCALING_SMOKE_RANKS,
                                    backend="gloo", device=dev)
            _check(set(res["throughput"]) == {"1", "2"}
                   and np.isfinite(res["objf_parity_10step_max_abs_delta"]),
                   "bench_scaling: 1 and 2 ranks, finite parity")
            _check(not torch.distributed.is_initialized(),
                   "bench_scaling: no process group left here")
            scaling = res["dense_den_launches"]
            _check(min(scaling) > 0, "bench_scaling: the ranks launched the "
                   "dense kernels")
            print(f"[tools] bench_scaling (2 gloo ranks on one card): "
                  + ", ".join(f"{n} ranks {r['chunks_per_s']} chunks/s"
                              for n, r in res["throughput"].items())
                  + "; adam parity "
                  f"{res['objf_parity_10step_max_abs_delta']:.2e} ({gpu})",
                  flush=True)
        with _tool("bench_dense_den"):
            res = bench_dense_den.run(out, **timing)
            _finite(res, ("plain_fwd", "kernel_fwd", "plain_fwd_grad",
                          "kernel_fwd_grad"), "bench_dense_den")
            _check(res["fwd_rel_err"] <= 1e-5
                   and res["grad_max_abs_err"] <= 1e-3,
                   "bench_dense_den: kernels equal the plain scan")
            print(f"[tools] bench_dense_den ms: kernel fwd "
                  f"{res['kernel_fwd']:.3f} / fwd+grad "
                  f"{res['kernel_fwd_grad']:.3f}, plain "
                  f"{res['plain_fwd']:.3f} / {res['plain_fwd_grad']:.3f}; "
                  f"fwd rel err {res['fwd_rel_err']:.2e}, grad err "
                  f"{res['grad_max_abs_err']:.2e} ({gpu})", flush=True)
    blocked = _blocked_launches(bdc)
    dense = tuple(a + b for a, b in zip(_dense_launches(ddc), scaling))
    _check(min(blocked) > 0 and min(dense) > 0,
           "phase 17 launched each of the four kernels")
    return blocked, dense


def _smoke(torch, phase, host_worker) -> int:
    """Phases 0-17, then the kernels line and the result line;
    ``host_worker`` builds phase 12's and phase 16's host set-ups."""
    sys.path.insert(0, REPO)
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import native
    from tdnnf_nas_torch.models import TdnnfModelConfig, count_params
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
    from tdnnf_nas_torch.ops import cuda_build
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig, init_train_state,
                                       make_train_step)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _gpu_name_power()
    print(f"gpu: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    with phase(0, "build"):
        # ---- 0. build: the kernels (nvcc), then the decoders, the loader
        # copy and the supervision builder (g++) ----
        # nvcc (one process per source) and the three g++ builds, all at
        # once
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            builds = [pool.submit(f) for f in (
                cuda_build.build, native.get_decoder_lib, native.get_lib,
                native.get_builder_lib)]
            sos = builds[0].result()
            for b in builds[1:]:
                b.result()
        bdc._library()
        ddc._library()
        builder = native.library_path(native.BUILDER_SOURCES, "egs_builder",
                                      native.BUILDER_FLAGS)
        decoders = native.library_path(native.DECODER_SOURCES, "decoders")
        print(f"[build] {', '.join(so.name for so in sos)}, "
              f"{decoders.name}, "
              f"{native.library_path().name} (csrc/egs_loader.cc), "
              f"{builder.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)

    with phase(1, "flagship setup"):
        # ---- 1. flagship host setup (bench.py:113-157) ----
        batch_size, chunk_width = FLAGSHIP_BATCH, FLAGSHIP_CHUNK
        (utts, phone_seqs, topo, tree, bundle, model_cfg, chunks, iv_rng,
         host_batches, g) = _flagship_setup(dev, host_worker)
        batches = [convert.batch_to_torch(b, dev) for b in host_batches]

    with phase(2, "blocked kernels"):
        # ---- 2. kernel vs plain at the flagship den shape ----
        blk = _blocked_check(torch, dev, gpu, g, tree.num_pdfs, batch_size)

    with phase(3, "train"):
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
              f"peak mem "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"launches fwd={launches['fwd']} bwd={launches['bwd']}; device "
              f"kernel launches per step {step_kernels} (profile) ({gpu})",
              flush=True)
        del held

    with phase(4, "f32 step"):
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
        _, m_p = _plain_step(torch, bdc,
                             lambda: step32(copy.deepcopy(st0), batches[0]),
                             "the plain step launched no kernel")
        _hold_f32_step(m_k, m_p, "f32 step", "f32 objf kernel vs plain",
                       mid=f"logz_den kernel={float(m_k['logz_den']):.9g} "
                           f"plain={float(m_p['logz_den']):.9g}; ")

        del state, st0, step, step32
        resident = batches[0]
        del batches

    with phase(5, "dense den"):
        dense, dense_bundle, dense_g = _dense_phase(torch, dev, gpu, utts,
                                                    phone_seqs, topo, iv_rng)

    with phase(6, "search"):
        search = _search_phase(
            torch, dev, gpu, dense_bundle, dense_g,
            TdnnfModelConfig(num_pdfs=2208, ivector_dim=0), batch_size=32,
            expect_params=(51_494_904, 23_232_504))
        for row, key in zip(dense, ("fwd", "bwd")):
            print(f"[launches] {row['name']}: dense training "
                  f"{row['launches']}, "
                  f"search {search[key]}", flush=True)
            row["launches"] += search[key]
        del dense_g

    with phase(7, "loader"):
        # ---- 7. the step fed from a TEGS shard through the native loader ----
        loader_launches = _loader_phase(torch, dev, gpu, chunks, g, model_cfg,
                                        trainer_cfg, resident)
        del chunks, resident  # phase 11 takes g, the bundle and host_batches

    with phase(8, "decode"):
        # ---- 8. the decode path at the flagship's width ----
        decode_launches, ctx = _decode_phase(torch, dev, gpu, tree, topo,
                                             dense_bundle)

    with phase(9, "rnnlm and lhuc"):
        # ---- 9. RNNLM rescoring and LHUC on phase 8's model and lattices ----
        lhuc_launches, b16 = _adapt_rescore_phase(torch, dev, gpu, ctx)
        del ctx

    with phase(10, "tri5_7d"):
        # ---- 10. the tri5_7d path: GMM ladder, +-1 tree, committed den ----
        pm1_launches, pm1 = _tri5_7d_phase(torch, dev, gpu, host_worker)

    with phase(11, "trainers"):
        # ---- 11. front end, optimizer kinds, Bayes/GP and CNN-TDNN-F ----
        trainer_launches = _trainers_phase(
            torch, dev, gpu, g, bundle, model_cfg,
            [convert.batch_to_torch(b, dev) for b in host_batches],
            chunk_width,
            batch_size)
        del g

    with phase(12, "factored den"):
        # ---- 12. the bench-scale +-1 den through the factored scan ----
        _factored_phase(torch, dev, gpu, utts, phone_seqs, topo, iv_rng,
                        dense_bundle, host_worker)
        torch.cuda.empty_cache()

    with phase(13, "data parallel"):
        # ---- 13. data parallel on the one card ----
        dp_launches = _dp_phase(torch, dev, gpu, bundle.den_arrays,
                                host_batches)

    # ---- 14. the whole flagship run, stages 1-9 ----
    with phase(14, "e2e flagship"):
        e2e_launches, e2e_setup, e2e_file = _e2e_phase(torch, dev, gpu)

    # ---- 15. the search experiments: sanity, planted table, WER ----
    with phase(15, "search experiments"):
        search_dense, search_blocked, b48 = _search_experiments_phase(
            torch, dev, gpu)

    # ---- 16. the comparison drivers ----
    with phase(16, "comparison drivers"):
        compare_blocked, compare_dense, ctx, wsd = _comparison_drivers_phase(
            torch, dev, gpu, host_worker, e2e_setup, e2e_file)
        del e2e_setup

    # ---- 17. the profile and bench tools ----
    with phase(17, "profile and bench tools"):
        tools_blocked, tools_dense = _tools_phase(torch, dev, gpu, tree,
                                                  bundle)

    for i, k in enumerate(("fwd", "bwd")):
        print(f"[launches] blocked_den_{k}: training {launches[k]}, "
              f"loader-fed phase {loader_launches[k]}, decode-phase "
              f"training {decode_launches[k]}, LHUC steps "
              f"{lhuc_launches[k]}, +-1 steps {pm1_launches[k]}, phase 11 "
              f"steps {trainer_launches[k]}, data-parallel phase "
              f"{dp_launches[k]}, e2e run {e2e_launches[k]}, search "
              f"experiments {search_blocked[i]}, comparison drivers "
              f"{compare_blocked[i]}, tools {tools_blocked[i]}", flush=True)
        launches[k] += (loader_launches[k] + decode_launches[k]
                        + lhuc_launches[k] + pm1_launches[k]
                        + trainer_launches[k] + dp_launches[k]
                        + e2e_launches[k] + search_blocked[i]
                        + compare_blocked[i] + tools_blocked[i])
    for i, row in enumerate(dense):
        k = ("fwd", "bwd")[i]
        print(f"[launches] {row['name']}: phases 5-6 {row['launches']}, "
              f"search experiments {search_dense[i]}, comparison drivers "
              f"{compare_dense[i]}, tools {tools_dense[i]}", flush=True)
        row["launches"] += search_dense[i] + compare_dense[i] + tools_dense[i]
        row["max_abs_err"] = max(row["max_abs_err"], wsd[k]["max_abs_err"])
        row.update({f"{key}_ws": v for key, v in wsd[k].items()})

    kernels = [
        {"name": f"blocked_den_{k}", "route": "cuda",
         "source": "tdnnf_nas_torch/csrc/blocked_den.cu",
         "replaces": f"{_TPU_KERNELS}:{line}", "launches": launches[k],
         **blk[k],
         "max_abs_err": max(blk[k]["max_abs_err"], b16[k]["max_abs_err"],
                            pm1[k]["max_abs_err"], b48[k]["max_abs_err"],
                            ctx[k]["max_abs_err"]),
         **{f"{key}_b16": v for key, v in b16[k].items()},
         **{f"{key}_pm1": v for key, v in pm1[k].items()},
         **{f"{key}_b48": v for key, v in b48[k].items()},
         **{f"{key}_ctx": v for key, v in ctx[k].items()}}
        for k, line in (("fwd", 282), ("bwd", 343))
    ] + dense
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


class _Phases:
    """Names each phase on stdout: ``[phase N name] start`` before it,
    ``[phase N name] ok <s> s`` after it; ``current`` is the phase that
    runs, or the last one that ended."""

    def __init__(self):
        self.current = "[before phase 0]"

    @contextlib.contextmanager
    def __call__(self, n: int, name: str):
        tag = f"[phase {n} {name}]"
        print(f"{tag} start", flush=True)
        self.current = tag
        t0 = time.perf_counter()
        yield
        print(f"{tag} ok {time.perf_counter() - t0:.1f} s", flush=True)
        self.current = f"[after phase {n} {name}]"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phase = _Phases()
    host_worker = _HostWorker()
    try:
        return _smoke(torch, phase, host_worker)
    except BaseException as e:
        # the failing phase by name, then the traceback, on stdout
        print(f"{phase.current} FAILED: {e!r}", flush=True)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        raise
    finally:
        host_worker.close()


if __name__ == "__main__":
    # a fault in a kernel or a native library names its Python frames, in
    # this process and in every process it starts
    faulthandler.enable(file=sys.stdout, all_threads=True)
    os.environ["PYTHONFAULTHANDLER"] = "1"
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":
        sys.exit(_dp_rank_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-nccl":
        sys.exit(_dp_nccl_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--host-worker":
        sys.exit(_host_worker_main(sys.argv[2]))
    sys.exit(main())
