"""PyTorch and CUDA port of the MementoHash system.

The reference package ``repro`` (JAX, Pallas kernels for the TPU) stays
beside this one and is never imported by it.  This package serves the
paper's path on an NVIDIA H100 for all five algorithms of the reference's
registry: host state → ``DeviceImageStore`` (epoch deltas through the
``delta_apply`` kernel) → ``engine_lookup`` / ``engine_diff`` (one lookup
and one diff kernel per algorithm) → ``SessionRouter.route_batch``, and
``repro_torch.sim`` replays the paper's scenarios through that stack.
``ShardedLookupPlane`` fans key batches over a device list
(``SessionRouter.route_stream``); the training substrates place data
shards (``ShardPlacement``, ``ElasticCluster``, movement plans from the
diff kernels) and checkpoint buckets (``save_checkpoint``) by consistent
hashing.
``repro_torch.launch`` replicates a leader's epochs to followers that hold
no host state: a frame codec equal word for word to the reference's,
``DeltaPublisher``, ``FollowerImageStore`` (frames replayed on the card by
the ``delta_apply`` kernels, lookups by the engine's), ``ReplicationGroup``
(flat or tree fan-out, catch-up) and ``torch.distributed`` broadcasts
between processes; ``repro_torch.sim`` replays with ``followers=``.
``repro_torch.obs`` is the telemetry plane: counters, gauges, log-bucketed
histograms, spans (``torch.profiler.record_function``, and NVTX ranges on
a CUDA build) and their exports, recorded by the engine, the store, the
router, the plane and replication on an injected or process-default
registry; ``ScenarioDriver(telemetry=True)`` scopes one to a replay.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``,
where every kernel is replaced by its plain torch version.
"""
from repro_torch import obs
from repro_torch.ckpt import (AsyncCheckpointer, latest_step, restore_checkpoint,
                              save_checkpoint)
from repro_torch.core import (DeviceImage, DeviceImageStore, MementoHash,
                              SyncHandle, SyncStats, make_hash)
from repro_torch.data import DataPipeline, ShardPlacement
from repro_torch.launch import DeltaPublisher, FollowerImageStore, ReplicationGroup
from repro_torch.runtime import ElasticCluster, StragglerMonitor
from repro_torch.serve.plane import ShardedLookupPlane
from repro_torch.serve.router import BatchScheduler, SessionRouter

__all__ = ["AsyncCheckpointer", "BatchScheduler", "DataPipeline", "DeltaPublisher",
           "DeviceImage", "DeviceImageStore", "ElasticCluster", "FollowerImageStore",
           "MementoHash", "ReplicationGroup", "SessionRouter", "ShardPlacement",
           "ShardedLookupPlane", "StragglerMonitor", "SyncHandle", "SyncStats",
           "latest_step", "make_hash", "obs", "restore_checkpoint", "save_checkpoint"]
