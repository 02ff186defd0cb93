from .logger import Logger, MetricLogger
from .timing import EpochTimer, PhaseTimer, op_time, time_fn
from .checkpoint import CheckpointManager

__all__ = [
    "Logger",
    "MetricLogger",
    "EpochTimer",
    "PhaseTimer",
    "op_time",
    "time_fn",
    "CheckpointManager",
]
