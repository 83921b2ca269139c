"""Track B: two-tier (HBM over host) memory runtime with the paper's
AMIL / bypass / CTC machinery applied to weights and KV pages: the block
table (its probe is the ``amil_probe`` kernel), the weight streamer and
the paged KV manager of the serving engine."""

from .block_table import TierConfig, access, init_state, probe_blocks
from .paged_kv import PagedKVConfig, PagedKVManager
from .weight_stream import Placement, WeightStreamer, plan_placement

__all__ = [
    "TierConfig", "access", "init_state", "probe_blocks",
    "PagedKVConfig", "PagedKVManager",
    "Placement", "WeightStreamer", "plan_placement",
]
