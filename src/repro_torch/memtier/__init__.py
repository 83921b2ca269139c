"""Two-tier memory runtime: the paged KV manager of the serving engine.
``block_table`` and ``weight_stream`` are not ported yet (ROADMAP A10)."""

from .paged_kv import PagedKVConfig, PagedKVManager

__all__ = ["PagedKVConfig", "PagedKVManager"]
