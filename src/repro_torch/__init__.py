"""PyTorch and CUDA port of the MementoHash system.

The reference package ``repro`` (JAX, Pallas kernels for the TPU) stays
beside this one and is never imported by it.  This package serves the
paper's path on an NVIDIA H100 for all five algorithms of the reference's
registry: host state → ``DeviceImageStore`` (epoch deltas through the
``delta_apply`` kernel) → ``engine_lookup`` / ``engine_diff`` (one lookup
and one diff kernel per algorithm) → ``SessionRouter.route_batch``, and
``repro_torch.sim`` replays the paper's scenarios through that stack.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``,
where every kernel is replaced by its plain torch version.
"""
from repro_torch.core import (DeviceImage, DeviceImageStore, MementoHash,
                              SyncHandle, SyncStats, make_hash)
from repro_torch.serve.router import BatchScheduler, SessionRouter

__all__ = ["BatchScheduler", "DeviceImage", "DeviceImageStore", "MementoHash",
           "SessionRouter", "SyncHandle", "SyncStats", "make_hash"]
