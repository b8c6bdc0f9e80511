"""One run of one cell of the port's benchmark.

A cell of ``BENCHMARK.json`` names a configuration (its file under
``portbench/configs/``) and a traffic mix (``portbench/traffic/<name>.json``);
the comparison's limits are in ``portbench/limits/<cell>.json``.  The
configuration's ``kind`` names the module under ``portbench/kinds/`` that
builds its host set-up, the program's step, the weights' shapes and the
plain reference, and its ``flops`` the counter under ``portbench/flops/``.
Each per-layer metric is read by ``portbench/metrics/<name>.py``.  So a
cell, a configuration or a metric is added by adding files.

A run: host set-up, weights and batches from ``--seed``, the program's
first three steps (recorded for the comparison), warm-up, the window of
``--seconds`` (and with ``--trace 1`` first a short profiled window), then
the plain reference over the first three steps and the result line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FIRST_STEPS = 3  # steps the reference follows
WARM_STEPS = 2  # further steps before the window
PROFILED_STEPS = 8  # covers two semi-orthogonal steps at interval 4
FORBIDDEN = ("jax", "jaxlib", "flax", "tdnnf_nas_tpu")
CHUNK_AUDIO_S = 0.01  # seconds of audio per input frame


# ------------------------------------------------------------------ cells

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict = None, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics, from
    ``root`` (a checkout: ``BENCHMARK.json`` unless ``bench`` is given,
    and the files under ``portbench/``)."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r} (known: "
                         f"{', '.join(sorted(cells))})")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    files = root / "portbench"
    return {"cell": cell, "config": load_json(root / config["file"]),
            "traffic": load_json(files / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(files / "limits" / f"{name}.json"),
            "per_layer": per_layer, "end_to_end": end_to_end}


def kind_module(config: dict):
    return importlib.import_module(f"portbench.kinds.{config['kind']}")


def seed32(seed: int, salt: int = 0) -> int:
    """A 32-bit seed for numpy's RandomState from any whole number."""
    return int(np.random.SeedSequence([int(seed), salt]).generate_state(1)[0])


# ----------------------------------------------------------------- weights

def make_weights(spec, seed: int, device):
    """The initial parameters from ``seed``: one normal draw on the
    device's generator for all random leaves, cut into leaves and scaled
    by 1/sqrt(fan_in); "eye" and "zeros" leaves are made as named.
    ``spec``: [(path, shape, init)] with init a fan-in, "eye" or "zeros".
    Returns the parameter tree; every leaf has storage of its own."""
    import torch

    from portbench.reference.train import rebuild

    sizes = [int(np.prod(shape)) for _, shape, init in spec
             if not isinstance(init, str)]
    g = torch.Generator(device)
    g.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    parts = iter(torch.split(flat, sizes))
    out = []
    for path, shape, init in spec:
        if init == "eye":
            x = torch.eye(shape[0], device=device)
        elif init == "zeros":
            x = torch.zeros(shape, device=device)
        else:
            x = next(parts).reshape(shape) / math.sqrt(init)
        out.append((path, x.clone()))
    return rebuild(out)


# ----------------------------------------------------------------- batches

def draw_batches(num_chunks: int, batch: int, count: int, seed: int):
    """``count`` batches of chunk indices drawn from ``seed``: a permutation
    of the pool cut into batches, every row distinct while the pool
    lasts."""
    if num_chunks < batch * count:
        raise ValueError(f"{num_chunks} chunks do not give {count} distinct "
                         f"batches of {batch}")
    perm = np.random.RandomState(seed32(seed, 1)).permutation(num_chunks)
    return [perm[i * batch:(i + 1) * batch] for i in range(count)]


def host_batch(chunks, rows, ivector_dim: int, rng):
    """The program's host batch of ``rows`` (``data.egs`` layout) with
    i-vectors from ``rng`` when the model takes them."""
    from tdnnf_nas_torch.graphs.supervision import stack_supervisions

    b = {"feats": np.stack([chunks[j].feats for j in rows]),
         "sup": stack_supervisions([chunks[j].sup for j in rows])}
    if ivector_dim:
        b["ivectors"] = rng.standard_normal(
            (len(rows), ivector_dim)).astype(np.float32)
    return b


def reference_batch(chunks, rows, host: dict, device):
    """The reference's view of a batch: the same features and i-vectors,
    and each chunk's numerator as its dense graph."""
    import torch

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    sups = [chunks[j].sup for j in rows]
    out = {"feats": t(host["feats"]),
           "sup": {"trans": t(np.stack([s.trans for s in sups])),
                   "state_pdf": t(np.stack([s.state_pdf for s in sups]),
                                  torch.int64),
                   "init": t(np.stack([s.init for s in sups])),
                   "final": t(np.stack([s.final for s in sups])),
                   "mask": t(np.stack([s.mask for s in sups]))}}
    if "ivectors" in host:
        out["ivectors"] = t(host["ivectors"])
    return out


# ---------------------------------------------------------------- feeding

class ResidentFeed:
    """Batches that sit on the card, cycled."""

    def __init__(self, host_batches, device):
        from tdnnf_nas_torch import convert

        self.batches = [convert.batch_to_torch(b, device)
                        for b in host_batches]
        self.i = 0
        self.wait_s = []

    def next(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b

    def close(self):
        self.batches = []


class LoaderFeed:
    """Batches read back from a TEGS shard by the native loader and staged
    by the prefetcher; records the host seconds each ``next`` waits and
    the rows of the first batches it hands over."""

    def __init__(self, chunks, order, traffic: dict, ivector_dim: int,
                 seed: int, tmpdir: str, device, keep: int):
        from tdnnf_nas_torch.data.egs_file import (NativeEgsLoader,
                                                   write_egs_file)
        from tdnnf_nas_torch.parallel import prefetch_to_device

        self.path = str(Path(tmpdir) / "portbench.tegs")
        write_egs_file([chunks[j] for j in order], self.path)
        self.loader = NativeEgsLoader(self.path, traffic["batch"],
                                      queue_depth=traffic["queue_depth"],
                                      seed=seed32(seed, 3))
        index = {chunks[j].feats.tobytes(): int(j) for j in order}
        rng = np.random.default_rng(seed32(seed, 2))
        self.seen = []  # (rows, host batch) of the first ``keep`` batches

        def host():
            for b in self.loader:
                if ivector_dim:
                    b["ivectors"] = rng.standard_normal(
                        (b["feats"].shape[0], ivector_dim)).astype(np.float32)
                if len(self.seen) < keep:
                    rows = [index[f.tobytes()] for f in b["feats"]]
                    self.seen.append((rows, {k: b[k] for k in
                                             ("feats", "ivectors") if k in b}))
                yield b

        self.it = prefetch_to_device(host(), size=traffic["prefetch"],
                                     device=device,
                                     payload_bf16=traffic["payload_bf16"])
        self.wait_s = []

    def next(self):
        t0 = time.perf_counter()
        b = next(self.it)
        self.wait_s.append(time.perf_counter() - t0)
        return b

    def close(self):
        close = getattr(self.it, "close", None)
        if close is not None:
            close()
        self.loader.close()
        Path(self.path).unlink(missing_ok=True)


# ------------------------------------------------------------------ checks

def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of | |prog| - |ref| | / max(|ref|, median |ref|)."""
    paths = [p for p in ref if keep is None or p in keep]
    med = statistics.median(float(ref[p]) for p in ref)
    return max(abs(float(prog[p]) - float(ref[p])) / max(float(ref[p]), med)
               for p in paths)


def leaf_diffs(prog: dict, ref: dict) -> dict:
    """|prog - ref| / max(|ref|, median |ref|) of the first gradient's
    vectors, by leaf (the program's on the host)."""
    import torch

    norms = {p: float(torch.linalg.vector_norm(v))
             for p, v in ref.items()}
    med = statistics.median(norms.values())
    return {p: float(torch.linalg.vector_norm(
        prog[p].to(v.device, v.dtype) - v)) / max(norms[p], med)
        for p, v in ref.items()}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the run is judged by, from the program's and the
    reference's first steps.  ``grad_gap`` and ``change_gap``: the gap
    between the norms of the first gradient and of the three steps'
    parameter change, by the worst leaf (leaves whose reference gradient
    is under a thousandth of the median leaf's are left out of the
    change); ``grad_diff``: the first gradient's difference by the median
    leaf, which an arithmetic in a lower precision moves at first order
    where the norms see it at second.  The losses are reported, not
    judged (PERF.md gives their readings and why)."""
    med = statistics.median(float(v) for v in ref["grad"].values())
    moving = {p for p, v in ref["grad"].items() if float(v) >= 1e-3 * med}
    return {"grad_gap": worst_leaf_gap(prog["grad"], ref["grad"]),
            "grad_diff": statistics.median(
                leaf_diffs(prog["grad_vec"], ref["grad_vec"]).values()),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"],
                                         moving)}


def loss_gaps(prog: dict, ref: dict):
    """Each step's loss gap, relative to the reference's loss."""
    return [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                ref["losses"])]


def run_reference(kind, config, setup, init_params, ref_batches, seed,
                  device, prec=None, dtype=None) -> dict:
    """The plain reference's losses, first gradient norms and change
    norms over the first steps, in float32 with TF32 off (``dtype``
    float64 gives the calibration's float64 reading)."""
    import torch

    from portbench.reference.train import Trainer

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        forward, den = kind.reference(config, setup, seed, device, prec)
        if dtype is not None:
            den = {k: v if k == "state_pdf" else v.to(dtype)
                   for k, v in den.items()}
            ref_batches = [cast_batch(b, dtype) for b in ref_batches]
        trainer = Trainer(init_params, forward, den, config["training"],
                          len(config["model"]["time_strides"]),
                          dtype=dtype)
        losses = [trainer.step(b) for b in ref_batches]
        from portbench.reference.train import leaves

        init = dict(leaves(init_params))
        change = {p: torch.linalg.vector_norm(x - init[p].to(x.dtype))
                  for p, x in zip(trainer.paths, trainer.params)}
        grad = {p: torch.linalg.vector_norm(g)
                for p, g in trainer.first_grads.items()}
        return {"losses": losses, "grad": grad,
                "grad_vec": trainer.first_grads, "change": change}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def cast_batch(b: dict, dtype) -> dict:
    """A reference batch with its floating tensors in ``dtype``."""
    out = {}
    for k, v in b.items():
        if isinstance(v, dict):
            out[k] = cast_batch(v, dtype)
        else:
            out[k] = v.to(dtype) if v.is_floating_point() else v
    return out


# -------------------------------------------------------------------- run

def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepClock:
    """Step-end events on the card (no host sync per step); on the CPU the
    host clock after each step."""

    def __init__(self, device):
        import torch

        self.device = device
        self.cuda = device.type == "cuda"
        self.marks = []
        self.steps = []
        self.torch = torch

    def start(self):
        self.mark(None)

    def mark(self, step):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        if step is not None:
            self.steps.append(step)

    def step_ms(self):
        if self.cuda:
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def start(c: dict, kind, setup: dict, seed: int, device, tmpdir: str,
          fault=None) -> dict:
    """Weights, the program's step and state, and the feed of batches,
    all from ``seed``.  ``first_rows``: [(chunk rows, host batch)] of the
    first steps where they are known before the feed runs."""
    config, traffic = c["config"], c["traffic"]
    chunks = setup["chunks"]
    ivector_dim = config["model"].get("ivector_dim", 0)
    rows = draw_batches(len(chunks), traffic["batch"], traffic["batches"],
                        seed)
    init_params = make_weights(kind.weights_spec(config), seed, device)
    prog = kind.program(config, setup, init_params, seed, device)
    step = prog["step"] if fault is None else fault(prog["step"])
    if traffic["feed"] == "resident":
        iv_rng = np.random.default_rng(seed32(seed, 2))
        hosts = [host_batch(chunks, r, ivector_dim, iv_rng) for r in rows]
        feed = ResidentFeed(hosts, device)
        first_rows = list(zip(rows[:FIRST_STEPS], hosts[:FIRST_STEPS]))
    else:
        feed = LoaderFeed(chunks, np.concatenate(rows), traffic, ivector_dim,
                          seed, tmpdir, device, FIRST_STEPS)
        first_rows = None
    return {"state": prog["state"], "step": step, "feed": feed,
            "init_params": init_params, "first_rows": first_rows}


def first_steps(config: dict, state, step, feed, init_params):
    """The program's first steps, through the window's own call and feed:
    (state, {"losses", "grad", "grad_vec", "change"}) with the first
    gradient by leaf (as Adam holds it after one step: its first moment
    over 1 - beta1; kept on the host) and its norms, and the norms of the
    parameters' change."""
    import torch

    from tdnnf_nas_torch.train.optimizer import tree_paths

    losses = []
    beta1 = config["training"]["optimizer"]["beta1"]
    for k in range(FIRST_STEPS):
        state, m = step(state, feed.next())
        losses.append(m["loss"])
        if k == 0:
            grad_vec = {p: (x / (1 - beta1)).cpu()
                        for p, x in tree_paths(state.opt_state["m"])}
    init = dict(tree_paths(init_params))
    change = {p: torch.linalg.vector_norm(x - init[p])
              for p, x in tree_paths(state.params)}
    return state, {"losses": [float(x) for x in losses],
                   "grad": {p: float(torch.linalg.vector_norm(v))
                            for p, v in grad_vec.items()},
                   "grad_vec": grad_vec,
                   "change": {p: float(v) for p, v in change.items()}}


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench: dict = None, root: Path = ROOT,
        tmpdir: str = None, fault=None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``fault`` (tests) wraps the program's step to break it."""
    import tempfile

    import torch

    from portbench import trace as tr

    c = load_cell(name, bench, root)
    config, traffic = c["config"], c["traffic"]
    kind = kind_module(config)
    spans = {}

    t0 = time.perf_counter()
    setup = kind.host_setup(config)
    spans["host_setup_s"] = time.perf_counter() - t0

    t_warm = time.perf_counter()
    kind.build_kernels(device)
    tmp = tempfile.TemporaryDirectory(dir=tmpdir)
    run_ = start(c, kind, setup, seed, device, tmp.name, fault)
    state, step, feed = run_["state"], run_["step"], run_["feed"]
    init_params, first_rows = run_["init_params"], run_["first_rows"]
    try:
        state, prog_first = first_steps(config, state, step, feed,
                                        init_params)
        if first_rows is None:
            first_rows = feed.seen[:FIRST_STEPS]
        for _ in range(WARM_STEPS):
            state, m = step(state, feed.next())
        float(m["loss"])
        _sync(device)
        spans["warmup_s"] = time.perf_counter() - t_warm

        profile = None
        if trace:
            # a profile late in a process may lose kernels: take it again
            # (at most three times) until each den kernel shows once a step
            for _ in range(3):
                res = tr.profile_steps(
                    lambda: step_n(step, state, feed, PROFILED_STEPS),
                    device, PROFILED_STEPS)
                state, profile = res["state"], res["summary"]
                if profile is None or profile["class_count"].get(
                        kind.DEN_CLASS, 0) == 2 * PROFILED_STEPS:
                    break
        setup_s = time.perf_counter() - t_start

        clock = StepClock(device)
        feed.wait_s = []
        window_losses = []
        t_w = time.perf_counter()
        clock.start()
        deadline = t_w + seconds
        while time.perf_counter() < deadline:
            k = state.step
            state, m = step(state, feed.next())
            clock.mark(k)
            window_losses.append(m["loss"])
        _sync(device)
        window_s = time.perf_counter() - t_w
        waits = list(feed.wait_s)
    finally:
        feed.close()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of the JAX package loaded: {found}")
    steps = len(clock.steps)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    step_ms = clock.step_ms()
    del state, m, feed, step, run_, window_losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_batches = [reference_batch(setup["chunks"], r, h, device)
                   for r, h in first_rows]
    ref = run_reference(kind, config, setup, init_params, ref_batches, seed,
                        device)
    numbers = compare(prog_first, ref)
    limits = c["limits"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    losses = loss_gaps(prog_first, ref)
    tmp.cleanup()

    audio_per_step = (traffic["batch"] * config["egs"]["chunk_width"]
                      * config["model"]["frame_subsampling_factor"]
                      * CHUNK_AUDIO_S)
    flops = kind.flops(config, traffic, setup)
    rec = {"spans": spans, "step_ms": step_ms, "step_index": clock.steps,
           "window_s": window_s, "steps": steps, "wait_s": waits,
           "profile": profile, "flops": flops,
           "semiorth_interval": config["training"]["semiorth_interval"]}
    e2e = {"audio_s_per_s": {"value": steps * audio_per_step / window_s,
                             "unit": "audio-s/s"},
           "step_ms_p95": {"value": percentile(step_ms, 95), "unit": "ms"},
           "setup_s": {"value": setup_s, "unit": "s"}}
    if trace:
        metrics = {}
        for m_def in c["per_layer"]:
            reader = importlib.import_module(
                f"portbench.metrics.{m_def['name']}")
            v = reader.read(rec)
            if v is not None:
                metrics[m_def["name"]] = {"value": v, "unit": m_def["unit"]}
    else:
        metrics = {m["name"]: e2e[m["name"]] for m in c["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        out["breakdown"] = profile["breakdown"]
    out["reported"] = {"loss_gaps": losses}
    out["checks"] = checks
    return out


def step_n(step, state, feed, n):
    for _ in range(n):
        state, _ = step(state, feed.next())
    return state


def percentile(xs, q):
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


# ------------------------------------------------------------------- main

def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of the "
                                 "port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = load_cell(args.workload)["cell"]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              device, t_start)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
