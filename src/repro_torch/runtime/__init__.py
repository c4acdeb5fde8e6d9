"""The fault-tolerant training runtime."""
from repro_torch.runtime.trainer import (  # noqa: F401
    SimulatedFailure, StragglerWatchdog, Trainer,
)
