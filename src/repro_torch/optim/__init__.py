"""AdamW with float32 master weights, and its learning-rate schedules."""
from . import adamw, schedule
from .adamw import AdamWConfig
