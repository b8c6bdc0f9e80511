"""Tiny versions of the benchmark's configurations, written as a checkout
of their own, for the CPU tests."""

import json
from pathlib import Path

STRIDES = [1, 1, 1, 0, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3]


def model(ivector_dim=6, **extra):
    m = {"feat_dim": 8, "ivector_dim": ivector_dim, "hidden_dim": 24,
         "bottleneck_dim": 6, "time_strides": STRIDES, "num_pdfs": 22,
         "prefinal_big": 16, "prefinal_small": 8, "bypass_scale": 0.66,
         "dropout_proportion": 0.0, "frame_subsampling_factor": 3,
         "compute_dtype": "float32"}
    m.update(extra)
    return m


def training(lr_final=2e-4, **objective):
    return {"objective": {"xent_regularize": 0.1, "leaky_hmm_coef": 0.1,
                          **objective},
            "optimizer": {"kind": "adam", "lr_initial": 1e-3,
                          "lr_final": lr_final, "num_steps": 200,
                          "beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                          "max_change_per_leaf": 0.75,
                          "max_change_global": 2.0},
            "semiorth_interval": 4}


CONFIGS = {
    "tiny-7q": {
        "name": "tiny-7q", "kind": "tdnnf", "model": model(),
        "corpus": {"num_utts": 48, "num_phones": 6, "feat_dim": 8,
                   "min_phones": 4, "max_phones": 8, "mean_dur": 4.0,
                   "context_shift": 1.0, "seed": 0},
        "tree": {"num_leaves": 16},
        "den": {"phone_lm_order": 4, "num_extra_lm_states": 20},
        "egs": {"chunk_width": 8, "max_phones_per_chunk": 8},
        "training": training()},
    "tiny-supernet": {
        "name": "tiny-supernet", "kind": "supernet",
        "model": model(ivector_dim=0, max_stride=2),
        "corpus": {"num_utts": 48, "num_phones": 6, "feat_dim": 8,
                   "min_phones": 4, "max_phones": 8, "mean_dur": 4.0,
                   "seed": 0},
        "tree": {"num_leaves": 16},
        "egs": {"chunk_width": 8, "max_phones_per_chunk": 8},
        "training": training(lr_final=3e-4)},
}

TRAFFIC = {
    "b4-resident": {"feed": "resident", "batch": 4, "batches": 8},
    "b4-loader": {"feed": "loader", "batch": 4, "batches": 8,
                  "queue_depth": 2, "prefetch": 2, "payload_bf16": False},
}

CELLS = [("tiny-7q", "b4-resident"), ("tiny-supernet", "b4-resident"),
         ("tiny-7q", "b4-loader")]

LIMITS = {"grad_gap": 1e-3, "grad_diff": 1e-3, "change_gap": 1e-3}


def write_checkout(root: Path, bench_from=None) -> dict:
    """Files of a checkout at ``root`` holding the tiny cells, and its
    BENCHMARK.json's object (metrics as in ``bench_from``)."""
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for name, cfg in CONFIGS.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    cells = [f"{c}.{t}" for c, t in CELLS]
    for cell in cells:
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": LIMITS}))
    bench = {"configs": [{"name": n, "file": f"portbench/configs/{n}.json"}
                         for n in CONFIGS],
             "workloads": [{"name": f"{c}.{t}", "config": c, "traffic": t,
                            "chips": 1} for c, t in CELLS],
             "end_to_end": [{"name": "audio_s_per_s", "unit": "audio-s/s"},
                            {"name": "step_ms_p95", "unit": "ms"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [dict(m, workloads=cells) for m in
                           (bench_from or {}).get("per_layer", [])]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench
