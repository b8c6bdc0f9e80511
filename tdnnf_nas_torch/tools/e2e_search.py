"""Stages 8-9 of the whole flagship run (``scripts/e2e_flagship.py``
:432-465 and :563-715), driven by ``tools/e2e_flagship.main``.

``bf16_ab`` trains the flagship in bf16 and in float32 at one budget
and seed and decodes the first 100 test utterances with each.
``run_search`` is the search table: the uniform offsets supernet (7q
base, strides 0-3), two gumbel cv-updates of its alphas from the same
supernet, the top-3 and the second seed's top-1 architectures, two
random ones and the manual 7q, each retrained, scored on the dev set and
decoded.  Every supernet, cv-update and child step launches the
blocked-den forward and adjoint kernels once, every valid batch the
forward once.

The search tools share the pieces of their tables: ``cv_batch_size``
(the cv-update's batch, capped at the dev split), ``child_row`` (a
child's retrain, its dev objf over the first valid batches, its decode
and its parameter count), ``mean_entropy``, ``rand_arch``,
``stride_pairs``, ``lookahead_reach`` and ``alpha_arrays``;
``tools/search_planted_table``, ``tools/search_sanity_planted`` and
``tools/e2e_wer_pipeline`` call them.
"""

from __future__ import annotations

import itertools
import json
from typing import Optional

import numpy as np

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.egs import batch_iterator
from tdnnf_nas_torch.models import DartsModelConfig, SearchMode, count_params
from tdnnf_nas_torch.nas import child_config_from_arch, extract_offsets
from tdnnf_nas_torch.recipes.chain_recipes import den_on_device, train_model
from tdnnf_nas_torch.tools.e2e_flagship import (BaseRun, Report, Setup,
                                                build_graph, build_hclg,
                                                decode, model_config,
                                                trainer_config)
from tdnnf_nas_torch.train import (OptimizerConfig, TrainerConfig,
                                   make_valid_step)

AB_WER_UTTS = 100  # :441
SEARCH_BATCH = 48  # :604, 623
VALID_BATCH, VALID_BATCHES = 16, 6  # :677-679
BASE_OPT = dict(kind="adam", lr_initial=1e-3, lr_final=1e-4)  # :595
MAX_STRIDE = 3  # :596


def bf16_ab(setup: Setup, g, report: Report, device=DEFAULT_DEVICE) -> dict:
    """Stage 8 (``:432-465``): bf16 and float32 trained at one budget
    (seed 11), each decoded on the first 100 test utterances; returns the
    content of ``bf16_parity.json``: per dtype the mean objf of the last
    20 steps, every 60th step's objf and the WER, then their WER
    difference."""
    dev = resolve_device(device)
    sizes = setup.sizes
    n_ab = sizes.ab_steps
    ab = {}
    for dtype in ("bfloat16", "float32"):
        mc = model_config(setup.tree, setup.cfg, dtype=dtype,
                          overrides=sizes.model_overrides)
        st, mets = train_model(setup.bundle, mc, trainer_config(n_ab), n_ab,
                               batch_size=64, chunk_width=50, seed=11,
                               device=dev)
        hist = report.trained(f"ab_{dtype}", mets)
        rep = decode(setup, mc, st, g, utts=setup.test[:AB_WER_UTTS],
                     device=dev)
        ab[dtype] = {"objf_final": round(float(np.mean(hist[-20:])), 4),
                     "objf_curve_10": [round(float(v), 4)
                                       for v in hist[::60]],
                     "wer": round(rep["wer"], 2)}
        print(f"[8] {dtype}: objf={ab[dtype]['objf_final']} "
              f"wer={ab[dtype]['wer']}", flush=True)
    ab["delta_wer"] = round(ab["bfloat16"]["wer"] - ab["float32"]["wer"], 2)
    ab["note"] = (f"identical {n_ab}-step budget, same seed/egs; bf16 is "
                  "the production compute dtype")
    return ab


def mean_entropy(a: np.ndarray) -> float:
    """Mean entropy of the rows' softmax (``:609-611``)."""
    p = np.exp(a) / np.exp(a).sum(-1, keepdims=True)
    return float(np.mean(-(p * np.log(p + 1e-20)).sum(-1)))


def rand_arch(seed: int, num_layers: int, max_stride: int = MAX_STRIDE):
    """A random (linear, affine) stride per layer (``:646-651``)."""
    rng = np.random.RandomState(seed)
    return tuple((int(rng.randint(0, max_stride + 1)),
                  int(rng.randint(0, max_stride + 1)))
                 for _ in range(num_layers))


def contenders(mc, top1, top2, seed2_top1) -> dict:
    """The table's child configs (``:653-665``); the second seed's top-1
    is left out when it equals the first's."""
    n = len(top1)
    out = {
        "searched_top1": child_config_from_arch(mc, stride_pairs=top1),
        "searched_top2": child_config_from_arch(mc, stride_pairs=top2),
        "searched_seed2_top1": child_config_from_arch(
            mc, stride_pairs=seed2_top1),
        "random_arch": child_config_from_arch(
            mc, stride_pairs=rand_arch(123, n)),
        "random_arch2": child_config_from_arch(
            mc, stride_pairs=rand_arch(456, n)),
        "manual_baseline": mc,
    }
    if seed2_top1 == top1:
        out.pop("searched_seed2_top1")
    return out


def stride_pairs(cfg):
    """(linear, affine) strides per layer as the table lists them."""
    return cfg.time_strides_asym or [(s, s) for s in cfg.time_strides]


def lookahead_reach(pairs) -> int:
    """Output frames a child sees ahead (``:691``): tdnn1's 1, each
    layer's affine stride, the prefinal's 2."""
    return 1 + sum(a for _, a in pairs) + 2


def alpha_arrays(state):
    """(linear, affine) offset alphas of a supernet state as numpy."""
    return tuple(state.alphas[k].detach().float().cpu().numpy()
                 for k in ("offsets_linear", "offsets_affine"))


def cv_batch_size(bundle, darts, chunk_width: int, tag: str,
                  batch: int = SEARCH_BATCH) -> int:
    """The cv-update's batch: ``batch``, or the dev split's supernet
    chunks when it holds fewer (the reference's ``train_model`` raises
    there; the cap is printed under ``tag``)."""
    n = min(batch, len(bundle.egs(None, chunk_width=chunk_width, dev=True,
                                  supernet_cfg=darts)))
    if n < batch:
        print(f"[{tag}] cv-update batch {n}: the dev split's chunks",
              flush=True)
    return n


def dev_objf(bundle, ccfg, tc, state, report: Report, chunk_width: int,
             num_batches: int, max_phones_per_chunk: int = 24,
             device=DEFAULT_DEVICE) -> float:
    """Mean valid-step objf over the first ``num_batches`` dev batches of
    16 (``RandomState(0)``; ``scripts/e2e_flagship.py:673-682``).  The
    reference's endless batch iterator never yields for fewer than 16 dev
    chunks; the port raises ValueError there."""
    vstep = make_valid_step(ccfg, tc, den_on_device(bundle, device))
    chunks = bundle.egs(ccfg, chunk_width=chunk_width,
                        max_phones_per_chunk=max_phones_per_chunk, dev=True)
    if len(chunks) < VALID_BATCH:
        raise ValueError(f"{len(chunks)} dev chunks for a valid batch of "
                         f"{VALID_BATCH}")
    vals = []
    for b in itertools.islice(batch_iterator(
            chunks, VALID_BATCH, np.random.RandomState(0)), num_batches):
        vals.append(float(vstep(state, convert.batch_to_torch(b, device))
                          ["objf_mmi"]))
        report.valid_batches += 1
    return float(np.mean(vals))


def child_row(bundle, ccfg, tc, num_steps: int, report: Report, name: str,
              batch_size: int, chunk_width: int, valid_batches: int,
              decode_fn=None, dev_max_phones: int = 24,
              log_every: int = 200, device=DEFAULT_DEVICE) -> dict:
    """One child of a search table, as every table trains it: ``num_steps``
    of ``train_model`` (seed 7, chunks of at most 24 phones), the dev objf
    over the first ``valid_batches`` dev batches (chunks of at most
    ``dev_max_phones``), and with ``decode_fn(ccfg, state)`` its WER.
    Returns the row: strides, lookahead_reach, params, train_objf,
    dev_objf (and wer), rounded as the references write them; its steps
    are recorded as ``child_<name>``."""
    st, mets = train_model(bundle, ccfg, tc, num_steps,
                           batch_size=batch_size, chunk_width=chunk_width,
                           seed=7, log_every=log_every, device=device)
    report.trained(f"child_{name}", mets)
    d_objf = dev_objf(bundle, ccfg, tc, st, report, chunk_width,
                      valid_batches, dev_max_phones, device=device)
    pairs = stride_pairs(ccfg)
    row = {"strides": [list(p) for p in pairs],
           "lookahead_reach": lookahead_reach(pairs),
           "params": int(count_params(st.params)),
           "train_objf": round(mets.last("objf_mmi"), 4),
           "dev_objf": round(d_objf, 4)}
    if decode_fn is not None:
        row["wer"] = round(decode_fn(ccfg, st)["wer"], 2)
    return row


def run_search(setup: Setup, base: Optional[BaseRun] = None,
               report: Optional[Report] = None,
               device=DEFAULT_DEVICE) -> dict:
    """Stage 9 (``:563-715``) on ``setup``, with ``base``'s HCLG (built
    here without one).  Returns and writes the content of
    ``search_table_flagship.json``."""
    dev = resolve_device(device)
    report = report if report is not None else Report()
    sizes, bundle = setup.sizes, setup.bundle
    if base is None:
        with report.stage("5 HCLG"):
            word_sym, lm3, _ = build_graph(setup.cfg, setup.prons,
                                           setup.word_seqs, setup.text,
                                           sizes.n_test)
            g = build_hclg(setup, lm3, word_sym)
    else:
        g = base.g
    mc = model_config(setup.tree, setup.cfg,
                      overrides=sizes.model_overrides)
    darts = DartsModelConfig(base=mc, search_offsets=True,
                             max_stride=MAX_STRIDE)
    n_pre, n_cv = sizes.pretrain_steps, sizes.cv_steps
    pre_tc = TrainerConfig(
        train_theta=True, train_alpha=False, search_mode=SearchMode.UNIFORM,
        optimizer=OptimizerConfig(num_steps=n_pre, **BASE_OPT))
    with report.stage("9 supernet"):
        sup_state, m = train_model(bundle, darts, pre_tc, n_pre,
                                   batch_size=SEARCH_BATCH, chunk_width=50,
                                   seed=0,
                                   supernet=True, log_every=100, device=dev)
        report.trained("supernet", m)
    # two cv-updates from the same supernet (seeds 1 and 11): does the
    # top-1 extraction repeat?  They step on the dev split, which the
    # reference's smoke sizes cut to 47 chunks: the batch is capped there
    # (the reference raises, as train_model does for a short split)
    cv = {}
    cv_batch = cv_batch_size(bundle, darts, 50, "9")
    with report.stage("9 cv-updates"):
        for cv_seed in (1, 11):
            cv_tc = TrainerConfig(
                train_theta=False, train_alpha=True, bn_frozen=True,
                search_mode=SearchMode.GUMBEL,
                optimizer=OptimizerConfig(num_steps=n_cv,
                                          alpha_lr_scale=30.0, **BASE_OPT))
            st, m = train_model(bundle, darts, cv_tc, n_cv,
                                batch_size=cv_batch, chunk_width=50,
                                seed=cv_seed, supernet=True,
                                init_state=sup_state, dev=True,
                                log_every=200, device=dev)
            report.trained(f"cv_{cv_seed}", m)
            cv[cv_seed] = alpha_arrays(st)
    del sup_state
    a_lin, a_aff = cv[1]
    ent = (mean_entropy(a_lin) + mean_entropy(a_aff)) / 2
    uniform_ent = float(np.log(a_lin.shape[-1]))
    archs = extract_offsets(a_lin, a_aff, top_k=3)
    top1 = archs[0][0]
    top2 = archs[1][0] if len(archs) > 1 else top1
    a_lin2, a_aff2 = cv[11]
    ent2 = (mean_entropy(a_lin2) + mean_entropy(a_aff2)) / 2
    seed2_top1 = extract_offsets(a_lin2, a_aff2, top_k=1)[0][0]
    agree = float(np.mean([a == b for a, b in
                           zip(np.ravel(top1), np.ravel(seed2_top1))]))
    print(f"[9] alpha entropy {ent:.3f} (seed 11: {ent2:.3f}) vs uniform "
          f"{uniform_ent:.3f}; top-1 agreement {agree:.2f}", flush=True)

    table = {}
    for name, ccfg in contenders(mc, top1, top2, seed2_top1).items():
        tc = trainer_config(sizes.child_steps)
        with report.stage(f"9 child {name}"):
            table[name] = child_row(
                bundle, ccfg, tc, sizes.child_steps, report, name,
                batch_size=64, chunk_width=50, valid_batches=VALID_BATCHES,
                decode_fn=lambda c, st: decode(setup, c, st, g, device=dev),
                dev_max_phones=40, log_every=250, device=dev)
        print(f"[9] {name}: dev_objf={table[name]['dev_objf']} "
              f"wer={table[name]['wer']}", flush=True)

    report.search = {
        "scale": "flagship (46 phones, 30k vocab, 7q supernet)",
        "alpha_entropy": round(ent, 3),
        "alpha_entropy_seed2": round(ent2, 3),
        "alpha_entropy_uniform": round(uniform_ent, 3),
        "cv_steps": n_cv,
        "top1_logprob": float(archs[0][1]),
        "seed_top1_agreement": round(agree, 3),
        "table": table,
    }
    report.save("search")
    print(json.dumps(report.search), flush=True)
    return report.search
