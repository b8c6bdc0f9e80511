"""Acoustic models and DARTS supernets."""
from tdnnf_nas_torch.models.nas import (BOTTLENECK_DIMS, BOTTLENECK_GROUPS,
                                        DartsModelConfig, SearchMode,
                                        apply_supernet, branch_coefs,
                                        expected_flops, init_supernet,
                                        supernet_context)
from tdnnf_nas_torch.models.tdnnf import (TdnnfModelConfig, apply_model,
                                          chunk_input_frames, count_params,
                                          estimate_lda, init_model,
                                          model_context)
