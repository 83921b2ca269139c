"""Atomic checkpoints in the JAX package's layout."""
from .ckpt import (AsyncCheckpointer, latest_step, load_state_leaves, restore,
                   save, state_leaves)
