"""Weak scaling of the data-parallel train step over ``torch.distributed``
ranks, and the exact data-parallel objf parity (port of
``scripts/bench_scaling.py``).

The world is the reference's: 96 utterances of 6 phones (12-dim
features), their bigram den (dense), a 64-wide TDNN-F of three layers in
float32 and chunks of 16 frames.  For 1, 2, 4, ... ranks up to
``--max-ranks``, each rank steps on ``--per-device`` (4) rows of a global
batch of ``per_device x ranks`` (the first batch of ``RandomState(0)``):
3 warm-up steps, then 10 timed ones give chunks/s, speedup and
efficiency against one rank.  Then every world size trains 10 steps on
one global batch of ``per_device x max_ranks`` rows (the first of
``RandomState(7)``), and the largest objf difference from one rank's
trajectory is the parity figure.

Where it differs from the reference:

- its virtual CPU mesh is a group of ranks here, one process each
  (``python -m tdnnf_nas_torch.tools.bench_scaling --rank DIR``, started
  by ``main``, which itself joins no group, so it leaves none behind):
  gloo ranks on the CPU with one thread each, NCCL with one rank per card
  on the card (the default), or gloo ranks sharing one card
  (``--backend gloo``);
- ``--kind`` picks the optimizer (the reference's is the default, Adam,
  whose g / sqrt(v) turns reduction-order noise into lr-sized steps, so
  its parity figure drifts; ``sgd`` holds to float32 noise);
- the file goes to ``--out DIR/scaling.json``, never to ``docs/``, with
  ``backend`` the device type, ``dist_backend`` the group's backend and
  ``dense_den_launches`` the dense-den kernels' launches summed over
  every rank (0 on the CPU); a host fetch of the objf closes the timed
  steps.

Usage: python3 -m tdnnf_nas_torch.tools.bench_scaling --out DIR
       [--device cuda|cpu] [--backend nccl|gloo] [--max-ranks N]
       [--per-device N] [--kind adam|sgd]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device

TIMED_STEPS, WARMUP_STEPS, PARITY_STEPS = 10, 3, 10
RANK_TIMEOUT_S = 600


def world():
    """(chunks, den StateGraph, model config) of ``:44-60``."""
    from tdnnf_nas_torch.data import (EgsConfig, SyntheticCorpusConfig,
                                      make_egs, make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (build_denominator_graph,
                                        den_init_lookup, estimate_phone_lm)
    from tdnnf_nas_torch.models import TdnnfModelConfig, model_context

    corpus_cfg = SyntheticCorpusConfig(num_utts=96, num_phones=6, feat_dim=12)
    utts, phone_seqs, tree, topo = make_synthetic_corpus(corpus_cfg)
    lm = estimate_phone_lm(phone_seqs, corpus_cfg.num_phones)
    den = build_denominator_graph(lm, topo, tree)
    model_cfg = TdnnfModelConfig(
        feat_dim=12, ivector_dim=0, hidden_dim=64, bottleneck_dim=16,
        time_strides=(1, 0, 3), num_pdfs=tree.num_pdfs, prefinal_big=64,
        prefinal_small=32, compute_dtype="float32")
    left, right = model_context(model_cfg)
    chunks = make_egs(utts, lm, topo, tree,
                      EgsConfig(chunk_width=16, left_context=left,
                                right_context=right, max_phones_per_chunk=12),
                      den_init_fn=den_init_lookup(den, corpus_cfg.num_phones))
    return chunks, den, model_cfg


def _rank_main(work: str) -> int:
    """One rank: the timed steps and the parity trajectory of its world
    size; rank 0 writes them to ``work/result.json``."""
    from tdnnf_nas_torch import parallel
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.train import (OptimizerConfig, TrainerConfig,
                                       init_train_state, make_train_step)

    with open(os.path.join(work, "config.json")) as f:
        cfg = json.load(f)
    dev = resolve_device(cfg["device"])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    parallel.initialize_from_env(backend=cfg["backend"], device=dev)
    try:
        mesh = parallel.make_mesh(device=dev)
        chunks, den, model_cfg = world()
        den_arr = DenGraphArrays.from_graph(den, mesh.device)
        tc = TrainerConfig(optimizer=OptimizerConfig(
            **({"kind": cfg["kind"]} if cfg["kind"] else {}),
            num_steps=1000))

        def fresh():
            state = init_train_state(model_cfg, tc,
                                     torch.Generator().manual_seed(0),
                                     mesh.device)
            return (parallel.put_replicated(state, mesh),
                    make_train_step(model_cfg, tc, den_arr, seed=1,
                                    mesh=mesh))

        def first(batch_size, seed):
            b = next(batch_iterator(chunks, batch_size=batch_size,
                                    rng=np.random.RandomState(seed)))
            return parallel.put_batch(b, mesh)

        state, step = fresh()
        batch = first(cfg["per_device"] * mesh.size, 0)
        for _ in range(WARMUP_STEPS):
            state, m = step(state, batch)
        float(m["objf_mmi"])
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, m = step(state, batch)
        float(m["objf_mmi"])  # a host fetch closes the timed steps
        dt = (time.perf_counter() - t0) / TIMED_STEPS

        state, step = fresh()
        gbatch = first(cfg["global_batch"], 7)
        traj = []
        for _ in range(PARITY_STEPS):
            state, m = step(state, gbatch)
            traj.append(float(m["objf_mmi"]))
        with open(os.path.join(work, f"launches{mesh.rank}.json"), "w") as f:
            json.dump([ddc.dense_den_fwd_cuda.launches,
                       ddc.dense_den_bwd_cuda.launches], f)
        if mesh.rank == 0:
            with open(os.path.join(work, "result.json"), "w") as f:
                json.dump({"step_s": dt, "traj": traj,
                           "chunks_per_s": cfg["per_device"] * mesh.size / dt,
                           "dist_backend": torch.distributed.get_backend()},
                          f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(n: int, cfg: dict, root: str) -> dict:
    """Starts ``n`` rank processes on ``cfg`` and waits for them; raises
    with the end of a failed rank's log."""
    work = os.path.join(root, f"ranks{n}")
    os.makedirs(work)
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump(cfg, f)
    port = _free_port()
    procs = []
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        for rank in range(n):
            env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                       NUM_PROCESSES=str(n), PROCESS_ID=str(rank),
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           [repo, os.environ.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tdnnf_nas_torch.tools.bench_scaling",
                 "--rank", work], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {n} exited {p.returncode}:\n"
                               f"{log[-3000:]}")
    with open(os.path.join(work, "result.json")) as f:
        res = json.load(f)
    res["launches"] = [0, 0]
    for rank in range(n):
        with open(os.path.join(work, f"launches{rank}.json")) as f:
            res["launches"] = [a + b for a, b in zip(res["launches"],
                                                     json.load(f))]
    return res


def run(out_dir=None, max_ranks=None, per_device: int = 4,
        backend=None, kind=None, device=DEFAULT_DEVICE) -> dict:
    """Runs every world size up to ``max_ranks`` (the card count on a
    card, 8 on the CPU as the reference's mesh); returns (and writes) the
    figures."""
    from tdnnf_nas_torch.tools.timing import write_json

    dev = resolve_device(device)
    if max_ranks is None:
        max_ranks = torch.cuda.device_count() if dev.type == "cuda" else 8
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    sizes = [1 << i for i in range(max_ranks.bit_length())
             if 1 << i <= max_ranks]
    cfg = {"device": str(dev), "backend": backend, "kind": kind,
           "per_device": per_device, "global_batch": per_device * sizes[-1]}
    results = {}
    with tempfile.TemporaryDirectory() as root:
        for n in sizes:
            results[n] = _run_ranks(n, cfg, root)
    base = results[1]["chunks_per_s"]
    print(f"{'ranks':>8} {'chunks/s':>10} {'speedup':>8} {'efficiency':>10}")
    rows = {}
    for n, r in results.items():
        thr = r["chunks_per_s"]
        print(f"{n:8d} {thr:10.1f} {thr / base:8.2f}x {thr / base / n:9.1%}")
        rows[str(n)] = {"chunks_per_s": round(thr, 1),
                        "speedup": round(thr / base, 3),
                        "efficiency": round(thr / base / n, 4)}
    one = results[1]["traj"]
    parity = max(max(abs(a - b) for a, b in zip(one, r["traj"]))
                 for r in results.values())
    print(f"{PARITY_STEPS}-step objf parity (same global batch, 1 vs N "
          f"ranks): max |delta| = {parity:.2e}", flush=True)
    note = (f"{sizes[-1]} {backend} ranks on "
            + (f"{torch.cuda.device_count()} card(s)" if dev.type == "cuda"
               else "the CPU, one thread each"))
    out = {"backend": dev.type, "dist_backend": backend, "note": note,
           "per_device_batch": per_device, "optimizer": kind or "adam",
           "throughput": rows, "objf_parity_10step_max_abs_delta": parity,
           "objf_trajectories": {str(n): r["traj"]
                                 for n, r in results.items()},
           "dense_den_launches": [sum(r["launches"][i]
                                      for r in results.values())
                                  for i in range(2)]}
    write_json(out_dir, "scaling.json", out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="directory for scaling.json")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--backend", choices=["nccl", "gloo"])
    ap.add_argument("--max-ranks", type=int)
    ap.add_argument("--per-device", type=int, default=4)
    ap.add_argument("--kind", choices=["adam", "sgd"])
    ap.add_argument("--rank", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        return _rank_main(args.rank)
    run(args.out, args.max_ranks, args.per_device, args.backend, args.kind,
        args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
