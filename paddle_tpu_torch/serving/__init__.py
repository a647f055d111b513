"""Serving: continuous batching over a paged KV cache (``Engine``), its
resilience layer (deadlines, priorities, shedding, probes, drain, the
out-of-memory ladder), serving-state durability (``snapshot``/``adopt``/
``handoff``) and crash/wedge supervision (``ServingSupervisor``)."""
from .engine import (DeadlineExceeded, Engine, EngineConfig, Overloaded,
                     Readiness, RequestCancelled, RequestHandle, ServeError)
from .pool import TRASH_BLOCK, PagePool, SnapshotError
from .supervisor import ServingSupervisor

__all__ = ["Engine", "EngineConfig", "RequestHandle", "ServeError",
           "RequestCancelled", "DeadlineExceeded", "Overloaded", "Readiness",
           "ServingSupervisor", "PagePool", "SnapshotError", "TRASH_BLOCK"]
