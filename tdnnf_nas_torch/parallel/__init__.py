"""Batch staging on the card and the data-parallel mesh."""
from tdnnf_nas_torch.parallel.mesh import (Mesh, compress_batch_bf16,
                                           dp_sharding, make_mesh,
                                           prefetch_to_device, put_batch,
                                           put_replicated,
                                           replicated_sharding)
from tdnnf_nas_torch.parallel.multihost import (global_mesh,
                                                host_batch_to_global,
                                                host_sharded_iterator,
                                                initialize_from_env,
                                                local_shard_range)
