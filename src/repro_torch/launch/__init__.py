"""Cross-process replication of the port: the frame codec, the leader's
publisher, device followers, in-process groups and ``torch.distributed``
transports (:mod:`repro_torch.launch.replicate`), and the process group
they ride (:mod:`repro_torch.launch.mesh`)."""
from .mesh import init_distributed
from .replicate import (DeltaPublisher, DistributedBroadcast, FollowerImageStore,
                        LoopbackChannel, ReplicationGroup, TreeBroadcast, TreeTopology,
                        WireStats, decode_frame, encode_delta, encode_snapshot, stamp_crc)

__all__ = ["DeltaPublisher", "DistributedBroadcast", "FollowerImageStore", "LoopbackChannel",
           "ReplicationGroup", "TreeBroadcast", "TreeTopology", "WireStats", "decode_frame",
           "encode_delta", "encode_snapshot", "init_distributed", "stamp_crc"]
