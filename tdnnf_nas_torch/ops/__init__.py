"""Device ops: forward-backward, spliced linear, semi-orthogonal step."""
from tdnnf_nas_torch.ops.dense_den_cuda import pallas_forward_score
from tdnnf_nas_torch.ops.fwdbwd import (BlockedDenGraph, DenGraphArrays,
                                        forward_score, forward_score_blocked,
                                        forward_score_linear,
                                        occupancy_posteriors)
from tdnnf_nas_torch.ops.semiorth import (semi_orthogonal_step,
                                          semi_orthogonal_step_3d)
from tdnnf_nas_torch.ops.tdnn import splice, spliced_linear
