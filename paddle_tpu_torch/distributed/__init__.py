"""Distributed training (port of ``paddle_tpu/distributed``): so far the
model-parallel helper collectives' single-rank form (``collective.py``) and
the single-device model-parallel layers (``fleet.meta_parallel``). Groups of
more than one rank come with ROADMAP A11."""
from . import collective, fleet

__all__ = ["collective", "fleet"]
