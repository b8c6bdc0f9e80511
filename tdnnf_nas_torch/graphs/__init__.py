"""Host-side chain graph machinery (numpy copies of ``tdnnf_nas_tpu.graphs``)."""
from tdnnf_nas_torch.graphs.den_graph import (BlockedDenGraph, CompiledDenFsa,
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
                                             TriphoneTree)
from tdnnf_nas_torch.graphs.tree_cluster import (accumulate_triphone_stats,
                                                 build_clustered_triphone_tree)
