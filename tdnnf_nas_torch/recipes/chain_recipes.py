"""Port of ``tdnnf_nas_tpu.recipes.chain_recipes``: the reference's shell
stages as Python functions.

  bootstrap_alignments_gmm
                    the GMM ladder's alignments (``gmm/``, on the card)
                    in place of the utterances' own
  prepare_data      estimates the phone LM, builds the denominator graph
                    and splits train/dev 95/5: a bigram LM with a CI or
                    left-biphone tree gives the dense den graph (a
                    ``graphs.fsa.StateGraph`` and its
                    ``ops.fwdbwd.DenGraphArrays``); a higher-order LM, a
                    left-2 or a +-1 tree gives the composed den FSA in
                    superblocked form, or in position-factored form
                    when the superblocked one is over its budget.
                    ``DataBundle.egs`` cuts the chunks for a model's
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
  forward_corpus    the batched acoustic forward of whole utterances on
                    the card (``nnet3-compute``'s batched analogue)
  decode_corpus     Viterbi phone decode against the dense den + PER
  decode_corpus_words
                    forward on the card, then the sparse-HCLG beam search
                    (C++ decoder, forked workers) with lattices on the
                    host, then WER (``steps/nnet3/decode.sh`` + scoring)

``train_model(mesh=)`` trains data parallel over a
``parallel.mesh.Mesh``.
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
from tdnnf_nas_torch.data.egs import (EgsConfig, _pad_feats, batch_iterator,
                                      make_egs)
from tdnnf_nas_torch.data import native as _native
from tdnnf_nas_torch.data.egs_file import NativeEgsLoader
from tdnnf_nas_torch.decode.beam import beam_decode_sparse
from tdnnf_nas_torch.decode.scoring import score_corpus
from tdnnf_nas_torch.decode.viterbi import (graph_log_arrays, path_to_phones,
                                            viterbi_decode)
from tdnnf_nas_torch.graphs.den_graph import (CompiledDenFsa,
                                              build_denominator_graph,
                                              compile_denominator_fsa,
                                              den_init_lookup)
from tdnnf_nas_torch.graphs.phone_lm import (estimate_ngram_phone_lm,
                                             estimate_phone_lm)
from tdnnf_nas_torch.models.nas import (DartsModelConfig, SearchMode,
                                        supernet_context)
from tdnnf_nas_torch.models.tdnnf import (TdnnfModelConfig, apply_model,
                                          model_context)
from tdnnf_nas_torch.nas.search import (child_config_from_arch,
                                        extract_bottlenecks, extract_offsets)
from tdnnf_nas_torch.graphs import den_graph as host_den
from tdnnf_nas_torch.ops.fwdbwd import (BlockedDenGraph, DenGraphArrays,
                                        FactoredDenGraph)
from tdnnf_nas_torch.parallel.mesh import prefetch_to_device, put_replicated
from tdnnf_nas_torch.train.trainer import (TrainerConfig, TrainState,
                                           init_train_state, make_train_step)


@dataclasses.dataclass
class DataBundle:
    lm: object  # PhoneLM (dense den) | NGramPhoneLM (composed den)
    # dense StateGraph; on the composed branch its dense export, or None
    # above prepare_data's max_dense_states
    den: object
    # dense: DenGraphArrays kept on the CPU on purpose
    # (DenGraphArrays.from_graph(den, dev) puts it on a device, see
    # den_on_device); composed: the host graphs.den_graph
    # BlockedDenGraph (ops.fwdbwd.BlockedDenGraph.from_host) or, when
    # to_blocked refuses the den, its FactoredDenGraph
    # (ops.fwdbwd.FactoredDenGraph.from_host)
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


def bootstrap_alignments_gmm(utts, phone_seqs, num_phones: int,
                             speakers=None, ladder_cfg=None,
                             device=DEFAULT_DEVICE):
    """Replace the utterances' phone begin/end alignments with GMM-ladder
    ones (mono -> LDA+MLLT -> SAT/fMLLR, ``gmm/ladder.py``, on ``device``)
    -- the classical bootstrap of the reference (`run.sh` GMM stages +
    `Prepare_NAS_data.sh:66-75` fMLLR aligns).

    Mutates and returns ``utts``; also returns the ladder result (model,
    transforms, diagnostics).
    """
    from tdnnf_nas_torch.gmm import GmmLadderConfig, run_gmm_ladder

    dev = resolve_device(device)
    cfg = ladder_cfg or GmmLadderConfig()
    res = run_gmm_ladder([u.feats for u in utts], phone_seqs, num_phones,
                         cfg, speakers=speakers, device=dev)
    for u, b, e in zip(utts, res.begins, res.ends):
        u.begins = list(b)
        u.ends = list(e)
    return utts, res


def prepare_data(utts, phone_seqs, tree, topo, num_phones: int,
                 dev_fraction: float = 0.05,
                 phone_lm_order: int = 2,
                 num_extra_lm_states: int = 2000,
                 max_dense_states: int = 4096,
                 ivectors=None) -> DataBundle:
    """Estimate the phone LM, build the den graph, split train/dev.

    The 95/5 split mirrors `Prepare_NAS_data.sh:5-7`.  ``phone_lm_order >
    2``, a tree with context_width > 2 or one with a right context takes
    the composed den FSA (for a +-1 tree the committed composition, whose
    blocked export carries the wildcard term) and its blocked export or,
    when that exceeds its size budget (ValueError), its factored export
    (the +-1 den at the bench's scale), as the reference does, with its
    dense ``StateGraph`` in ``den`` when it has at most
    ``max_dense_states`` states (the phone decode's graph); otherwise the
    bigram LM gives the dense den graph.
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
    den = comp.to_state_graph() if comp.num_states <= max_dense_states else None
    try:
        den_arrays = comp.to_blocked()
    except ValueError:  # the padded blocks are over their budget
        den_arrays = comp.to_factored()
    return DataBundle(
        lm=lm, den=den, den_arrays=den_arrays, tree=tree, topo=topo,
        train_utts=train, dev_utts=dev, num_phones=num_phones,
        den_fsa=comp, train_ivectors=iv_train, dev_ivectors=iv_dev,
    )


def den_on_device(bundle: DataBundle, device):
    """The bundle's den graph as the objective takes it, on ``device``."""
    if isinstance(bundle.den_arrays, DenGraphArrays):
        if torch.device(device).type == "cpu":
            return bundle.den_arrays
        return DenGraphArrays.from_graph(bundle.den, device)
    if isinstance(bundle.den_arrays, host_den.FactoredDenGraph):
        return FactoredDenGraph.from_host(bundle.den_arrays, device)
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
    max_phones_per_chunk: int = 24,
    device=DEFAULT_DEVICE,
    mesh=None,
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
    ``log_every`` prints step/objf/rate progress.  Chunks with more than
    ``max_phones_per_chunk`` phones are dropped (``DataBundle.egs``; the
    reference always takes its default, 24).

    With a data-parallel ``mesh`` (``parallel.mesh.make_mesh``) every
    rank calls train_model with the same arguments and runs on the
    mesh's device in place of ``device``: the state is rank 0's
    (``put_replicated``), ``batch_size`` is the global batch, of which
    each rank steps on its rows, and rank 0 alone writes checkpoints.
    """
    device = resolve_device(device) if mesh is None else mesh.device
    state = init_state
    if state is None:
        state = init_train_state(model_cfg, trainer_cfg,
                                 torch.Generator().manual_seed(seed),
                                 device, supernet=supernet)
    if mesh is not None:
        state = put_replicated(state, mesh)
    step = make_train_step(model_cfg, trainer_cfg,
                           den_on_device(bundle, device), seed=seed + 1,
                           supernet=supernet, mesh=mesh)
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
                            max_phones_per_chunk=max_phones_per_chunk,
                            supernet_cfg=model_cfg if supernet else None)
        if len(chunks) < batch_size:
            raise ValueError(
                f"only {len(chunks)} chunks for batch {batch_size}")
        host = batch_iterator(chunks, batch_size=batch_size,
                              rng=np.random.RandomState(seed))
    host = itertools.islice(host, num_steps)
    if mesh is not None:  # this rank's rows of each global batch
        host = (convert.map_batch(lambda _, a: a[mesh.rows(len(a))], b)
                for b in host)
    writer = mesh is None or mesh.rank == 0
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
            if (writer and ckpt_dir and ckpt_interval
                    and (i + 1) % ckpt_interval == 0):
                save_checkpoint(ckpt_dir, i + 1, state, meta)
    finally:
        it.close()  # a prefetcher stops and joins its worker first
        if loader is not None:
            loader.close()
    if writer and ckpt_dir:
        save_checkpoint(ckpt_dir, num_steps, state, meta)
    return state, metrics


def _ivector_batch(model_cfg, ivectors, idx, device):
    """[len(idx), D] i-vectors on ``device`` (zeros without ``ivectors``),
    or None for a model that takes none."""
    if not model_cfg.ivector_dim:
        return None
    if ivectors is None:
        iv = np.zeros((len(idx), model_cfg.ivector_dim), np.float32)
    else:
        iv = np.stack([np.asarray(ivectors[i], np.float32) for i in idx])
    return torch.from_numpy(iv).to(device)


def decode_corpus(
    bundle: DataBundle,
    model_cfg,
    state: TrainState,
    utts=None,
    chunk_output_frames: int = 0,
    ivectors=None,
    device=DEFAULT_DEVICE,
) -> dict:
    """Viterbi phone decode of whole utterances + PER vs the true phones.

    Pads each utterance's features with the model context and decodes the
    full output sequence against the bundle's dense denominator graph
    (``bundle.den``), one utterance at a time: the forward and the Viterbi
    run on ``device``.  ``ivectors``: per-utterance vectors for a model
    that takes them (zeros if omitted; the reference passes none, so it
    decodes only i-vector-free models).  ``chunk_output_frames`` is unused,
    as in the reference.
    """
    dev = resolve_device(device)
    utts = utts if utts is not None else bundle.dev_utts
    params = convert.tree_to_device(state.params, dev)
    bn_state = convert.tree_to_device(state.bn_state, dev)
    left, right = model_context(model_cfg)
    lt, spdf, li, lf = graph_log_arrays(bundle.den, dev)
    refs, hyps = [], []
    bucket = 32  # pad output lengths to multiples (the reference's shapes)
    fs = model_cfg.frame_subsampling_factor
    with torch.inference_mode():
        for i, utt in enumerate(utts):
            t_out = len(utt.pdf_align)
            t_pad = ((t_out + bucket - 1) // bucket) * bucket
            need = left + (t_pad - 1) * fs + 1 + right
            feats = torch.from_numpy(
                _pad_feats(utt.feats, left, need)[None, :need])
            chain, _, _ = apply_model(
                model_cfg, params, bn_state, feats.to(dev),
                _ivector_batch(model_cfg, ivectors, [i], dev), train=False)
            _, paths = viterbi_decode(chain[:, :t_out].float(), lt, spdf, li,
                                      lf)
            hyps.append(path_to_phones(paths[0].cpu().numpy(),
                                       bundle.num_phones))
            refs.append(list(utt.phones))
    return score_corpus(refs, hyps)


def forward_corpus(
    bundle_or_cfg,
    model_cfg,
    state: TrainState,
    utts,
    bucket: int = 64,
    batch_size: int = 16,
    ivectors=None,
    device=DEFAULT_DEVICE,
):
    """Batched acoustic forward of whole utterances on ``device``.

    Utterances are bucketed by output length padded to a multiple of
    ``bucket`` and stacked into [batch_size, T_in, F] batches: each
    utterance edge-repeated by the model context and cut to the bucket's
    input length, the tail group padded to ``batch_size`` by repeating
    its first row, zero i-vectors when ``ivectors`` is None and the model
    takes them (the reference's padding, which fixes its jit shapes).
    ``apply_model(train=False)`` runs under ``torch.inference_mode()``;
    ``state``'s params are copied to ``device`` if they live elsewhere.
    Returns per-utterance float32 numpy [T_out, P] log-outputs (chain
    head).  ``bundle_or_cfg`` is unused, as in the reference.
    """
    dev = resolve_device(device)
    params = convert.tree_to_device(state.params, dev)
    bn_state = convert.tree_to_device(state.bn_state, dev)
    left, right = model_context(model_cfg)
    fs = model_cfg.frame_subsampling_factor
    buckets = {}
    for i, utt in enumerate(utts):
        t_out = len(utt.pdf_align) if utt.pdf_align is not None else (
            utt.feats.shape[0] // fs)
        t_pad = ((t_out + bucket - 1) // bucket) * bucket
        buckets.setdefault(t_pad, []).append((i, utt, t_out))

    outs = [None] * len(utts)
    with torch.inference_mode():
        for t_pad, items in sorted(buckets.items()):
            need = left + (t_pad - 1) * fs + 1 + right
            for j in range(0, len(items), batch_size):
                group = items[j: j + batch_size]
                n = len(group)
                idx = [i for i, _, _ in group]
                # pad the tail group by repeating its first row
                idx += [idx[0]] * (batch_size - n)
                feats = np.stack(
                    [_pad_feats(u.feats, left, need)[:need]
                     for _, u, _ in group]
                    + [_pad_feats(group[0][1].feats, left, need)[:need]]
                    * (batch_size - n))
                chain, _, _ = apply_model(
                    model_cfg, params, bn_state,
                    torch.from_numpy(feats).to(dev),
                    _ivector_batch(model_cfg, ivectors, idx, dev),
                    train=False)
                chain = chain.float().cpu().numpy()
                for (i, _, t_out), row in zip(group, chain[:n]):
                    outs[i] = row[:t_out]
    return outs


_DECODE_SHARED = None  # (graph, outs, kwargs) for forked decode workers


def _decode_worker(i: int):
    graph, outs, kw = _DECODE_SHARED
    res = beam_decode_sparse(outs[i], graph, **kw)
    return i, res.words, (res.lattice if kw["lattice"] else None)


def decode_corpus_words(
    bundle_or_cfg,
    model_cfg,
    state: TrainState,
    graph,
    utts,
    acoustic_scale: float = 1.0,
    beam: float = 14.0,
    max_active: int = 7000,
    lattice: bool = False,
    lattice_beam: float = 7.0,
    bucket: int = 64,
    batch_size: int = 16,
    num_workers: int = 0,
    retry_beam: float = 0.0,
    ivectors=None,
    device=DEFAULT_DEVICE,
) -> dict:
    """Eval-set word decoding: batched forward on ``device`` + sparse beam
    search + WER (the `steps/nnet3/decode.sh` + scoring equivalent over the
    graph_sparse HCLG).  Returns {"wer", "sub", "ins", "del", "ref_len",
    "hyps", "lattices"?}.

    The search is the C++ decoder (``decode.beam.beam_decode_sparse``'s
    default).  ``num_workers`` > 0 fans the per-utterance searches out
    over forked host processes (Kaldi's decode.sh --nj split): the
    decoder's library is loaded in the parent first, and the forward's
    outputs are numpy arrays before the fork, so no child touches CUDA.
    A died beam is re-decoded up to ``retry_beam`` (default 4x ``beam``).
    """
    outs = forward_corpus(bundle_or_cfg, model_cfg, state, utts,
                          bucket=bucket, batch_size=batch_size,
                          ivectors=ivectors, device=device)
    kw = dict(acoustic_scale=acoustic_scale, beam=beam,
              max_active=max_active, lattice=lattice,
              lattice_beam=lattice_beam,
              retry_beam=retry_beam if retry_beam else beam * 4.0)
    if num_workers and len(outs) > 1:
        import multiprocessing as mp

        global _DECODE_SHARED
        _native.get_decoder_lib()  # built and loaded before the fork
        _DECODE_SHARED = (graph, outs, kw)
        try:
            with mp.get_context("fork").Pool(num_workers) as pool:
                results = pool.map(_decode_worker, range(len(outs)),
                                   chunksize=1)
        finally:
            _DECODE_SHARED = None
        results.sort(key=lambda r: r[0])
        hyps = [r[1] for r in results]
        lats = [r[2] for r in results]
    else:
        hyps, lats = [], []
        for obs in outs:
            res = beam_decode_sparse(obs, graph, **kw)
            hyps.append(res.words)
            lats.append(res.lattice if lattice else None)
    refs = [list(u.words) for u in utts]
    rep = score_corpus(refs, hyps)
    rep["hyps"] = hyps
    if lattice:
        rep["lattices"] = lats
    return rep


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
