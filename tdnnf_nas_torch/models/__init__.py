"""Acoustic models."""
from tdnnf_nas_torch.models.tdnnf import (TdnnfModelConfig, apply_model,
                                          chunk_input_frames, count_params,
                                          init_model, model_context)
