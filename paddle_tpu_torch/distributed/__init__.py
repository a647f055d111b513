"""Distributed training (port of ``paddle_tpu/distributed``): so far the
model-parallel helper collectives' single-rank form (``collective.py``) and
the single-device model-parallel layers (``fleet.meta_parallel``). Groups of
more than one rank come with ROADMAP A11."""
from . import collective, fleet
from .collective import get_rank, get_world_size

__all__ = ["collective", "fleet", "get_rank", "get_world_size"]
