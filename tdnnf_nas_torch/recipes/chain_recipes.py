"""Port of ``tdnnf_nas_tpu.recipes.chain_recipes``: the reference's shell
stages as Python functions.

  prepare_data      estimates the phone LM, builds the denominator graph
                    and splits train/dev 95/5: a bigram LM with a CI or
                    left-biphone tree gives the dense den graph (a
                    ``graphs.fsa.StateGraph`` and its
                    ``ops.fwdbwd.DenGraphArrays``); a higher-order LM or a
                    left-2 tree gives the composed den FSA in superblocked
                    form.  ``DataBundle.egs`` cuts the chunks for a model's
                    (or supernet's) receptive field.
  train_model       the iteration loop (`steps/nnet3/chain/train.py`),
                    fed by ``batch_iterator`` or a TEGS shard's native
                    loader through the CUDA-stream prefetcher, with
                    checkpoints
  run_offset_search_pipeline
                    uniform one-hot pretrain (95%) -> alpha-only cv-update
                    on the 5% dev split, theta and BN frozen -> beam-search
                    extraction -> child retrain
  run_bottleneck_search_pipeline
                    the same for the nested-mask bottleneck search, with
                    the FLOPs penalty in the cv-update

The data-parallel mesh and the decoding recipes wait for later slices.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.core.checkpoint import save_checkpoint
from tdnnf_nas_torch.core.config import asdict_config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.core.metrics import MetricsLogger
from tdnnf_nas_torch.data.egs import EgsConfig, batch_iterator, make_egs
from tdnnf_nas_torch.data.egs_file import NativeEgsLoader
from tdnnf_nas_torch.graphs.den_graph import (CompiledDenFsa,
                                              build_denominator_graph,
                                              compile_denominator_fsa,
                                              den_init_lookup)
from tdnnf_nas_torch.graphs.phone_lm import (estimate_ngram_phone_lm,
                                             estimate_phone_lm)
from tdnnf_nas_torch.models.nas import (DartsModelConfig, SearchMode,
                                        supernet_context)
from tdnnf_nas_torch.models.tdnnf import TdnnfModelConfig, model_context
from tdnnf_nas_torch.nas.search import (child_config_from_arch,
                                        extract_bottlenecks, extract_offsets)
from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph, DenGraphArrays
from tdnnf_nas_torch.parallel.mesh import prefetch_to_device
from tdnnf_nas_torch.train.trainer import (TrainerConfig, TrainState,
                                           init_train_state, make_train_step)


@dataclasses.dataclass
class DataBundle:
    lm: object  # PhoneLM (dense den) | NGramPhoneLM (composed den)
    den: object  # dense StateGraph; None on the composed branch
    # dense: DenGraphArrays kept on the CPU on purpose
    # (DenGraphArrays.from_graph(den, dev) puts it on a device, see
    # den_on_device); composed: the host graphs.den_graph
    # BlockedDenGraph (ops.fwdbwd.BlockedDenGraph.from_host)
    den_arrays: object
    tree: object
    topo: object
    train_utts: list
    dev_utts: list
    num_phones: int
    den_fsa: CompiledDenFsa = None
    egs_stats: dict = dataclasses.field(default_factory=dict)
    train_ivectors: object = None
    dev_ivectors: object = None
    _egs_cache: dict = dataclasses.field(default_factory=dict)

    def egs(self, model_cfg, chunk_width=20, dev=False, tol=2,
            max_phones_per_chunk=24, supernet_cfg=None):
        if supernet_cfg is not None:
            left, right = supernet_context(supernet_cfg)
        else:
            left, right = model_context(model_cfg)
        # chunks depend only on (context, widths, tol, split): models with
        # the same receptive field reuse one build
        key = (left, right, chunk_width, dev, tol, max_phones_per_chunk)
        cached = self._egs_cache.get(key)
        if cached is not None:
            return cached
        cfg = EgsConfig(
            chunk_width=chunk_width, left_context=left, right_context=right,
            tolerance=tol, max_phones_per_chunk=max_phones_per_chunk,
        )
        utts = self.dev_utts if dev else self.train_utts
        ivs = self.dev_ivectors if dev else self.train_ivectors
        if self.den_fsa is not None:
            chunks = make_egs(utts, self.lm, self.topo, self.tree, cfg,
                              den_fsa=self.den_fsa, stats=self.egs_stats,
                              ivectors=ivs)
        else:
            chunks = make_egs(
                utts, self.lm, self.topo, self.tree, cfg,
                den_init_fn=den_init_lookup(self.den, self.num_phones),
                stats=self.egs_stats, ivectors=ivs)
        self._egs_cache[key] = chunks
        return chunks


def prepare_data(utts, phone_seqs, tree, topo, num_phones: int,
                 dev_fraction: float = 0.05,
                 phone_lm_order: int = 2,
                 num_extra_lm_states: int = 2000,
                 ivectors=None) -> DataBundle:
    """Estimate the phone LM, build the den graph, split train/dev.

    The 95/5 split mirrors `Prepare_NAS_data.sh:5-7`.  ``phone_lm_order >
    2``, a tree with context_width > 2 or one with a right context takes
    the composed den FSA and its blocked export, which raises ValueError
    when it exceeds its size budget (the factored fallback is not ported;
    the +-1 composition raises NotImplementedError); otherwise the bigram
    LM gives the dense den graph.
    """
    n_dev = max(1, int(len(utts) * dev_fraction))
    dev, train = utts[:n_dev], utts[n_dev:]
    iv_dev = ivectors[:n_dev] if ivectors is not None else None
    iv_train = ivectors[n_dev:] if ivectors is not None else None
    composed = (phone_lm_order > 2 or getattr(tree, "context_width", 1) > 2
                or getattr(tree, "right_context", 0) > 0)
    if not composed:
        lm = estimate_phone_lm(phone_seqs, num_phones)
        den = build_denominator_graph(lm, topo, tree)
        return DataBundle(
            lm=lm, den=den, den_arrays=DenGraphArrays.from_graph(den, "cpu"),
            tree=tree, topo=topo, train_utts=train, dev_utts=dev,
            num_phones=num_phones,
            train_ivectors=iv_train, dev_ivectors=iv_dev,
        )
    lm = estimate_ngram_phone_lm(phone_seqs, num_phones,
                                 order=max(phone_lm_order, 2),
                                 num_extra_lm_states=num_extra_lm_states)
    comp = compile_denominator_fsa(lm, topo, tree)
    return DataBundle(
        lm=lm, den=None, den_arrays=comp.to_blocked(), tree=tree, topo=topo,
        train_utts=train, dev_utts=dev, num_phones=num_phones,
        den_fsa=comp, train_ivectors=iv_train, dev_ivectors=iv_dev,
    )


def den_on_device(bundle: DataBundle, device):
    """The bundle's den graph as the objective takes it, on ``device``."""
    if isinstance(bundle.den_arrays, DenGraphArrays):
        if torch.device(device).type == "cpu":
            return bundle.den_arrays
        return DenGraphArrays.from_graph(bundle.den, device)
    return BlockedDenGraph.from_host(bundle.den_arrays, device)


def train_model(
    bundle: DataBundle,
    model_cfg,
    trainer_cfg: TrainerConfig,
    num_steps: int,
    batch_size: int = 8,
    chunk_width: int = 20,
    seed: int = 0,
    supernet: bool = False,
    init_state: Optional[TrainState] = None,
    dev: bool = False,
    metrics: Optional[MetricsLogger] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_interval: int = 0,
    prefetch: int = 2,
    egs_path: Optional[str] = None,
    log_every: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[TrainState, MetricsLogger]:
    """The iteration loop (`train.py:473-570` equivalent).

    Batches come from ``batch_iterator`` shuffled by
    ``RandomState(seed)`` (the reference's batch order) or, given
    ``egs_path``, from that TEGS shard through ``NativeEgsLoader`` seeded
    ``seed`` (a shard holds no i-vectors).  With ``prefetch`` > 0 they
    reach ``device`` through ``parallel.prefetch_to_device``, staged that
    many batches ahead; with 0, one ``convert.batch_to_torch`` per step.
    Metrics logging is deferred (core/metrics.py).  The initial state is
    drawn from ``torch.Generator().manual_seed(seed)``, and step k's
    samples from a generator seeded ``step_seed(seed + 1, k)``, so a run
    resumed from a checkpoint continues as the unbroken run would.  With
    ``ckpt_dir`` the state is saved every ``ckpt_interval`` steps (if >
    0) and after the last, the configs in the checkpoint's meta.
    ``log_every`` prints step/objf/rate progress.
    """
    device = resolve_device(device)
    state = init_state
    if state is None:
        state = init_train_state(model_cfg, trainer_cfg,
                                 torch.Generator().manual_seed(seed),
                                 device, supernet=supernet)
    step = make_train_step(model_cfg, trainer_cfg,
                           den_on_device(bundle, device), seed=seed + 1,
                           supernet=supernet)
    metrics = metrics or MetricsLogger()
    meta = {"model": asdict_config(model_cfg),
            "trainer": asdict_config(trainer_cfg), "supernet": supernet}
    loader = None
    if egs_path is not None:
        loader = NativeEgsLoader(egs_path, batch_size, seed=seed)
        host = iter(loader)
    else:
        chunks = bundle.egs(model_cfg if not supernet else None,
                            chunk_width=chunk_width, dev=dev,
                            supernet_cfg=model_cfg if supernet else None)
        if len(chunks) < batch_size:
            raise ValueError(
                f"only {len(chunks)} chunks for batch {batch_size}")
        host = batch_iterator(chunks, batch_size=batch_size,
                              rng=np.random.RandomState(seed))
    host = itertools.islice(host, num_steps)
    it = (prefetch_to_device(host, size=prefetch, device=device) if prefetch
          else (convert.batch_to_torch(b, device) for b in host))
    t_last, i_last = time.time(), 0
    try:
        for i, batch in enumerate(it):
            state, m = step(state, batch)
            metrics.log(i, m)
            if log_every and (i + 1) % log_every == 0:
                now = time.time()
                rate = (i + 1 - i_last) / max(now - t_last, 1e-9)
                t_last, i_last = now, i + 1
                print(f"[train] step {i + 1}/{num_steps} "
                      f"objf_mmi={metrics.last('objf_mmi'):.4f} "
                      f"({rate:.1f} steps/s)", flush=True)
            if ckpt_dir and ckpt_interval and (i + 1) % ckpt_interval == 0:
                save_checkpoint(ckpt_dir, i + 1, state, meta)
    finally:
        it.close()  # a prefetcher stops and joins its worker first
        if loader is not None:
            loader.close()
    if ckpt_dir:
        save_checkpoint(ckpt_dir, num_steps, state, meta)
    return state, metrics


def run_offset_search_pipeline(
    bundle: DataBundle,
    base_cfg: TdnnfModelConfig,
    max_stride: int = 3,
    pretrain_steps: int = 60,
    cvupdate_steps: int = 40,
    child_steps: int = 60,
    cv_mode: str = SearchMode.GUMBEL,
    batch_size: int = 8,
    chunk_width: int = 20,
    seed: int = 0,
    trainer_kw: Optional[dict] = None,
    child_top_k: int = 1,
    device=DEFAULT_DEVICE,
):
    """Two-stage context-offset DARTS (reference steps 6a-6d).

    Stage B starts from stage A's state, step counter included, so its
    temperature and its alpha Adam's bias correction start at
    ``pretrain_steps`` (as in the reference).  Returns a dict with the
    supernet state, the extracted archs, each child's cfg and state, and
    the metric loggers.
    """
    device = resolve_device(device)
    tkw = trainer_kw or {}
    darts_cfg = DartsModelConfig(base=base_cfg, search_offsets=True,
                                 max_stride=max_stride)
    common = dict(batch_size=batch_size, chunk_width=chunk_width,
                  device=device)
    # stage A: 95% uniform-sample pretrain (theta only)
    pre_cfg = TrainerConfig(train_theta=True, train_alpha=False,
                            search_mode=SearchMode.UNIFORM, **tkw)
    sup_state, pre_metrics = train_model(
        bundle, darts_cfg, pre_cfg, pretrain_steps, seed=seed,
        supernet=True, **common)
    # stage B: 5% cv alpha-only update, theta + BN frozen
    cv_cfg = TrainerConfig(train_theta=False, train_alpha=True,
                           bn_frozen=True, search_mode=cv_mode, **tkw)
    sup_state, cv_metrics = train_model(
        bundle, darts_cfg, cv_cfg, cvupdate_steps, seed=seed + 1,
        supernet=True, init_state=sup_state, dev=True, **common)
    # extraction (beam search over alpha softmax)
    archs = extract_offsets(
        convert.tree_to_numpy(sup_state.alphas["offsets_linear"]),
        convert.tree_to_numpy(sup_state.alphas["offsets_affine"]),
        top_k=max(child_top_k, 1))
    results = {"supernet_state": sup_state, "pretrain_metrics": pre_metrics,
               "cvupdate_metrics": cv_metrics, "archs": archs,
               "children": []}
    # stage C: child retrain on full data
    for pairs, lp in archs[:child_top_k]:
        child_cfg = child_config_from_arch(base_cfg, stride_pairs=pairs)
        child_state, child_metrics = train_model(
            bundle, child_cfg, TrainerConfig(**tkw), child_steps,
            seed=seed + 2, **common)
        results["children"].append(
            {"cfg": child_cfg, "state": child_state,
             "metrics": child_metrics, "arch_logprob": lp})
    return results


def run_bottleneck_search_pipeline(
    bundle: DataBundle,
    base_cfg: TdnnfModelConfig,
    bottleneck_groups: Tuple[int, ...] = (4, 4, 8),
    fixed_strides: Optional[Tuple[Tuple[int, int], ...]] = None,
    pretrain_steps: int = 60,
    cvupdate_steps: int = 40,
    child_steps: int = 60,
    flops_coef: float = 0.0,
    batch_size: int = 8,
    chunk_width: int = 20,
    seed: int = 0,
    trainer_kw: Optional[dict] = None,
    device=DEFAULT_DEVICE,
):
    """Bottleneck-dim search (reference steps 7a-7d; the stage-8 combo when
    fixed_strides comes from a prior offset search)."""
    device = resolve_device(device)
    tkw = trainer_kw or {}
    strides = tuple(fixed_strides or base_cfg.stride_pairs)
    darts_cfg = DartsModelConfig(
        base=base_cfg, search_offsets=False, fixed_strides=strides,
        search_bottleneck=True, bottleneck_groups=tuple(bottleneck_groups))
    common = dict(batch_size=batch_size, chunk_width=chunk_width,
                  device=device)
    pre_cfg = TrainerConfig(train_theta=True, train_alpha=False,
                            search_mode=SearchMode.UNIFORM, **tkw)
    sup_state, pre_metrics = train_model(
        bundle, darts_cfg, pre_cfg, pretrain_steps, seed=seed,
        supernet=True, **common)
    cv_cfg = TrainerConfig(train_theta=False, train_alpha=True,
                           bn_frozen=True, search_mode=SearchMode.GUMBEL,
                           flops_coef=flops_coef, **tkw)
    sup_state, cv_metrics = train_model(
        bundle, darts_cfg, cv_cfg, cvupdate_steps, seed=seed + 1,
        supernet=True, init_state=sup_state, dev=True, **common)
    archs = extract_bottlenecks(
        convert.tree_to_numpy(sup_state.alphas["bottleneck"]),
        darts_cfg.bottleneck_candidates, top_k=1)
    dims, _ = archs[0]
    child_cfg = child_config_from_arch(base_cfg, stride_pairs=strides,
                                       bottleneck_dims=dims)
    child_state, child_metrics = train_model(
        bundle, child_cfg, TrainerConfig(**tkw), child_steps, seed=seed + 2,
        **common)
    return {"supernet_state": sup_state, "pretrain_metrics": pre_metrics,
            "cvupdate_metrics": cv_metrics, "archs": archs,
            "child_cfg": child_cfg, "child_state": child_state,
            "child_metrics": child_metrics}
