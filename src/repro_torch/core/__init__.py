"""Host control plane and device images of the port: the five algorithms
of the reference's registry, their epoch deltas, and the device store."""
from .anchor import AnchorHash
from .dx import DxHash
from .image_store import DeviceImageStore, SyncHandle, SyncStats
from .jump import JumpHash
from .memento import MementoHash, random_state
from .power import PowerHash
from .protocol import (ALGORITHM_REGISTRY, ALGORITHMS, DeviceImage, ImageDelta,
                       image_fingerprint, make_hash)

__all__ = ["ALGORITHMS", "ALGORITHM_REGISTRY", "AnchorHash", "DeviceImage",
           "DeviceImageStore", "DxHash", "ImageDelta", "JumpHash", "MementoHash",
           "PowerHash", "SyncHandle", "SyncStats", "image_fingerprint", "make_hash",
           "random_state"]
