"""Copy of ``tdnnf_nas_tpu.recipes.chain_recipes`` (data preparation).

``prepare_data`` estimates the pruned n-gram phone LM, composes the
denominator FSA and exports it in superblocked form, and splits train/dev
95/5; ``DataBundle.egs`` cuts the chunks for a model's receptive field.
Only the composed (4-gram / triphone) branch is ported; the dense bigram
denominator and the training/decoding recipes wait for later slices.
"""

from __future__ import annotations

import dataclasses

from tdnnf_nas_torch.data.egs import EgsConfig, make_egs
from tdnnf_nas_torch.graphs.den_graph import (BlockedDenGraph,
                                              CompiledDenFsa,
                                              compile_denominator_fsa)
from tdnnf_nas_torch.graphs.phone_lm import NGramPhoneLM, estimate_ngram_phone_lm
from tdnnf_nas_torch.models.tdnnf import model_context


@dataclasses.dataclass
class DataBundle:
    lm: NGramPhoneLM
    den_arrays: BlockedDenGraph  # host export; ops.fwdbwd moves it on device
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
            max_phones_per_chunk=24):
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
        chunks = make_egs(utts, self.lm, self.topo, self.tree, cfg,
                          den_fsa=self.den_fsa, stats=self.egs_stats,
                          ivectors=ivs)
        self._egs_cache[key] = chunks
        return chunks


def prepare_data(utts, phone_seqs, tree, topo, num_phones: int,
                 dev_fraction: float = 0.05,
                 phone_lm_order: int = 2,
                 num_extra_lm_states: int = 2000,
                 ivectors=None) -> DataBundle:
    """Estimate the phone LM, build the blocked den graph, split train/dev.

    The 95/5 split mirrors `Prepare_NAS_data.sh:5-7`.  Raises
    NotImplementedError for a bigram LM with a biphone-or-smaller tree
    (the dense denominator is not ported), and ValueError when the blocked
    export exceeds its size budget (the factored fallback is not ported).
    """
    composed = (phone_lm_order > 2
                or getattr(tree, "context_width", 1) > 2)
    if not composed:
        raise NotImplementedError(
            "the dense bigram denominator is not ported yet")
    n_dev = max(1, int(len(utts) * dev_fraction))
    dev, train = utts[:n_dev], utts[n_dev:]
    iv_dev = ivectors[:n_dev] if ivectors is not None else None
    iv_train = ivectors[n_dev:] if ivectors is not None else None
    lm = estimate_ngram_phone_lm(phone_seqs, num_phones,
                                 order=max(phone_lm_order, 2),
                                 num_extra_lm_states=num_extra_lm_states)
    comp = compile_denominator_fsa(lm, topo, tree)
    return DataBundle(
        lm=lm, den_arrays=comp.to_blocked(), tree=tree, topo=topo,
        train_utts=train, dev_utts=dev, num_phones=num_phones,
        den_fsa=comp, train_ivectors=iv_train, dev_ivectors=iv_dev,
    )
