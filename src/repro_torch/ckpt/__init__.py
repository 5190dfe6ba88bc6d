"""Checkpoint substrate of the port: Memento-placed bucket files, a
manifest, and an asynchronous writer, in the reference's layout."""
from .store import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint", "save_checkpoint"]
