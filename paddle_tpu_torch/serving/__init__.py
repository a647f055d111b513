"""Serving: continuous batching over a paged KV cache (``Engine``)."""
from .engine import (Engine, EngineConfig, RequestCancelled, RequestHandle,
                     ServeError)
from .pool import TRASH_BLOCK, PagePool

__all__ = ["Engine", "EngineConfig", "RequestHandle", "ServeError",
           "RequestCancelled", "PagePool", "TRASH_BLOCK"]
