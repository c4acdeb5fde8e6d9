"""Atomic checkpoints in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer, latest, load, save,
)
