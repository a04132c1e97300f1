"""Crash-safe checkpointing (port of ``repro.checkpoint``): trees of
tensors (:func:`save_checkpoint`, :func:`load_checkpoint`) and full engine
resume closures (:func:`save_engine_checkpoint`, :func:`restore`), in the
reference's on-disk format."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.engine_io import (
    engine_fingerprint,
    restore,
    save_engine_checkpoint,
)

__all__ = [
    "CheckpointError",
    "save_checkpoint",
    "load_checkpoint",
    "save_engine_checkpoint",
    "restore",
    "engine_fingerprint",
]
