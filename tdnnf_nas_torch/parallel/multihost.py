"""Multi-process initialisation and sharded data feeding (port of
``tdnnf_nas_tpu.parallel.multihost``).

Every process runs the same program, one rank per device, and the dp mesh
spans all ranks; each rank feeds only its rows of the global batch, and
the train step all-reduces gradients through the mesh: no model
averaging, no .mdl files in flight.  ``torch.distributed`` takes the
place of ``jax.distributed``; the environment names are the reference's
(``COORDINATOR_ADDRESS`` as host:port, ``NUM_PROCESSES``,
``PROCESS_ID``).  Without ``COORDINATOR_ADDRESS`` a program runs as one
process, as the reference's does.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.parallel.mesh import Mesh, make_mesh


def initialize_from_env(backend: Optional[str] = None,
                        device=DEFAULT_DEVICE) -> bool:
    """``torch.distributed.init_process_group`` from COORDINATOR_ADDRESS
    (host:port of rank 0), NUM_PROCESSES and PROCESS_ID when they are set;
    returns whether it set up a group.  The backend is NCCL for a CUDA
    ``device`` (the default) and gloo for the CPU, or ``backend`` as
    given (gloo with CUDA tensors runs several ranks on one card, which
    NCCL refuses); a backend that fails to start raises, and no other is
    tried."""
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        return False
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{addr}",
        world_size=int(os.environ["NUM_PROCESSES"]),
        rank=int(os.environ["PROCESS_ID"]))
    return True


def global_mesh(axis_name: str = "dp", device=DEFAULT_DEVICE) -> Mesh:
    """The 1-D dp mesh over all ranks."""
    return make_mesh(axis_name=axis_name, device=device)


def _process_count_index():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_batch_to_global(batch: dict, mesh: Mesh) -> dict:
    """This rank's local batch (its rows of the global batch, whose size
    is the local one times the ranks) on its device: each rank holds its
    own shard of the global batch."""
    return convert.batch_to_torch(batch, mesh.device)


def local_shard_range(num_items: int) -> tuple:
    """[start, end) of this rank's contiguous shard of a dataset (the last
    rank takes the remainder)."""
    pc, pid = _process_count_index()
    per = num_items // pc
    start = pid * per
    end = num_items if pid == pc - 1 else start + per
    return start, end


def host_sharded_iterator(chunks, batch_size: int, mesh: Mesh, rng,
                          epochs=None):
    """Per-rank egs feeding: each rank shuffles and batches only its
    contiguous shard of the chunk list (the replacement of Kaldi's per-job
    egs archives, `train.py:477-549`), ``batch_size`` in total across the
    ranks.  ``batch_size`` must divide by the number of ranks."""
    from tdnnf_nas_torch.data import batch_iterator

    pc, _ = _process_count_index()
    if batch_size % pc:
        raise ValueError(f"batch_size {batch_size} does not split over "
                         f"{pc} processes")
    start, end = local_shard_range(len(chunks))
    for batch in batch_iterator(chunks[start:end], batch_size // pc, rng=rng,
                                epochs=epochs):
        yield host_batch_to_global(batch, mesh)
