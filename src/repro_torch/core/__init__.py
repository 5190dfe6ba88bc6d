"""Host control plane and device images of the port (MementoHash only in
this slice)."""
from .image_store import DeviceImageStore, SyncHandle, SyncStats
from .memento import MementoHash, random_state
from .protocol import (ALGORITHM_REGISTRY, ALGORITHMS, DeviceImage, ImageDelta,
                       image_fingerprint, make_hash)

__all__ = ["ALGORITHMS", "ALGORITHM_REGISTRY", "DeviceImage", "DeviceImageStore",
           "ImageDelta", "MementoHash", "SyncHandle", "SyncStats",
           "image_fingerprint", "make_hash", "random_state"]
