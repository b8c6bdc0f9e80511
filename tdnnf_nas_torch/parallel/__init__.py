"""Batch staging on the card; the data-parallel mesh waits for its slice."""
from tdnnf_nas_torch.parallel.mesh import (compress_batch_bf16,
                                           prefetch_to_device)
