"""Host control plane and device images of the port: the five algorithms
of the reference's registry, the bounded-load overlay, their epoch deltas,
the packed layouts, and the device store."""
from .anchor import AnchorHash
from .bounded import (BoundedLoad, BoundedLoadMemento, accept_in_index_order,
                      bounded_assign_ref, walk_probe_bound)
from .dx import DxHash
from .image_store import DeviceImageStore, SyncHandle, SyncStats
from .jump import JumpHash
from .memento import MementoHash, random_state
from .power import PowerHash
from .protocol import (ALGORITHM_REGISTRY, ALGORITHMS, DeviceImage, ImageDelta,
                       image_fingerprint, make_hash, replica_sets)
from .tables import MementoTables, tables_from_state

__all__ = ["ALGORITHMS", "ALGORITHM_REGISTRY", "AnchorHash", "BoundedLoad",
           "BoundedLoadMemento", "DeviceImage", "DeviceImageStore", "DxHash",
           "ImageDelta", "JumpHash", "MementoHash", "MementoTables", "PowerHash",
           "SyncHandle", "SyncStats", "accept_in_index_order", "bounded_assign_ref",
           "image_fingerprint", "make_hash", "random_state", "replica_sets",
           "tables_from_state", "walk_probe_bound"]
