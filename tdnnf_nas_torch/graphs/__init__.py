"""Host-side chain graph machinery (numpy copies of ``tdnnf_nas_tpu.graphs``)."""
from tdnnf_nas_torch.graphs.den_graph import (BlockedDenGraph, CompiledDenFsa,
                                              FactoredDenGraph,
                                              build_denominator_graph,
                                              compile_denominator_fsa,
                                              den_init_lookup)
from tdnnf_nas_torch.graphs.fsa import StateGraph, stationary_init
from tdnnf_nas_torch.graphs.phone_lm import (NGramPhoneLM, PhoneLM,
                                             estimate_ngram_phone_lm,
                                             estimate_phone_lm)
from tdnnf_nas_torch.graphs.supervision import (ChunkSupervision,
                                                make_chunk_supervision,
                                                stack_supervisions)
from tdnnf_nas_torch.graphs.topology import (BiphoneTree, ChainTopology,
                                             ContextIndependentTree,
                                             CrossTriphoneTree, TriphoneTree)
from tdnnf_nas_torch.graphs.tree_cluster import (
    ClusteredBiphoneTree, TreeStats, TriphoneStats,
    accumulate_cross_triphone_stats, accumulate_tree_stats,
    accumulate_triphone_stats, build_clustered_cross_triphone_tree,
    build_clustered_tree, build_clustered_triphone_tree,
    build_tree_from_corpus)
