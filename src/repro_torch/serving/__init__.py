"""Serving: the batched engine with the two-tier paged KV cache."""

from .engine import Engine, Request, ServeConfig

__all__ = ["Engine", "Request", "ServeConfig"]
