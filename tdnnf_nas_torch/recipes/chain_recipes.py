"""Copy of ``tdnnf_nas_tpu.recipes.chain_recipes`` (data preparation).

``prepare_data`` estimates the phone LM, builds the denominator graph
and splits train/dev 95/5: a bigram LM with a CI or left-biphone tree
gives the dense den graph (a ``graphs.fsa.StateGraph`` and its
``ops.fwdbwd.DenGraphArrays``); a higher-order LM or a left-2 tree gives
the composed den FSA in superblocked form.  ``DataBundle.egs`` cuts the
chunks for a model's receptive field.  The training and decoding recipes
wait for later slices.
"""

from __future__ import annotations

import dataclasses

from tdnnf_nas_torch.data.egs import EgsConfig, make_egs
from tdnnf_nas_torch.graphs.den_graph import (CompiledDenFsa,
                                              build_denominator_graph,
                                              compile_denominator_fsa,
                                              den_init_lookup)
from tdnnf_nas_torch.graphs.phone_lm import (estimate_ngram_phone_lm,
                                             estimate_phone_lm)
from tdnnf_nas_torch.models.tdnnf import model_context
from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays


@dataclasses.dataclass
class DataBundle:
    lm: object  # PhoneLM (dense den) | NGramPhoneLM (composed den)
    den: object  # dense StateGraph; None on the composed branch
    # dense: DenGraphArrays on the CPU (DenGraphArrays.from_graph(den, dev)
    # puts it on a device); composed: the host graphs.den_graph
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
    2`` or a tree with context_width > 2 takes the composed den FSA and its
    blocked export, which raises ValueError when it exceeds its size budget
    (the factored fallback is not ported); otherwise the bigram LM gives
    the dense den graph.
    """
    n_dev = max(1, int(len(utts) * dev_fraction))
    dev, train = utts[:n_dev], utts[n_dev:]
    iv_dev = ivectors[:n_dev] if ivectors is not None else None
    iv_train = ivectors[n_dev:] if ivectors is not None else None
    composed = (phone_lm_order > 2
                or getattr(tree, "context_width", 1) > 2)
    if not composed:
        lm = estimate_phone_lm(phone_seqs, num_phones)
        den = build_denominator_graph(lm, topo, tree)
        return DataBundle(
            lm=lm, den=den, den_arrays=DenGraphArrays.from_graph(den),
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
