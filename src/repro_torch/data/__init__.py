"""Data substrate of the port: consistent-hash shard placement with device
movement plans, and a deterministic, resumable synthetic pipeline."""
from .pipeline import DataPipeline, ShardPlacement, synthetic_shard_tokens

__all__ = ["DataPipeline", "ShardPlacement", "synthetic_shard_tokens"]
