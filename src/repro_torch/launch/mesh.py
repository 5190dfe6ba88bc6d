"""Process groups of the port (the port's own copy of the reference's
``launch/mesh.py``, cut to :func:`init_distributed`; device enumeration
and the rest of that module are not ported yet)."""
from __future__ import annotations


def init_distributed(address: str, num_processes: int, process_id: int, *,
                     backend: str = "gloo") -> None:
    """Join the ``torch.distributed`` group of cross-process delta
    replication (:mod:`repro_torch.launch.replicate`): rank 0 owns
    membership, the other ranks receive its frames.  ``address`` is the
    rank-0 ``host:port`` every process dials.  Frames are CPU tensors, so
    the default ``gloo`` carries them whatever device the images use."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=num_processes, rank=process_id)
