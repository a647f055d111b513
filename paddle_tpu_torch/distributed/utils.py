"""Expert-parallel routing (port of ``paddle_tpu/distributed/utils.py``).

``global_scatter`` sends each rank's token rows to the ranks that own their
experts and ``global_gather`` brings them back: over a group of more than
one rank each is the tiled all-to-all of dim 0 (equal parts, part ``j`` to
rank ``j``, the parts received concatenated in rank order), whose backward
is the reverse exchange, as the reference's ``lax.all_to_all(...,
tiled=True)`` inside a ``shard_map``. With no group, or a group of one,
both are the identity. ``local_count`` and ``global_count`` are accepted
and not read: the reference's capacity buckets are equal.
"""
from __future__ import annotations

from .collective import _all_to_all_tiled


def global_scatter(x, local_count=None, global_count=None, group=None):
    """Token rows to their experts' owners over ``group``."""
    return _all_to_all_tiled(x, group, 0, 0)


def global_gather(x, local_count=None, global_count=None, group=None):
    """The expert outputs back to their tokens' ranks over ``group``."""
    return _all_to_all_tiled(x, group, 0, 0)


def get_cluster_from_args(args, selected_gpus=None):
    raise NotImplementedError(
        "one process a rank: start the ranks with the launcher's variables "
        "(PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ID, PADDLE_TRAINER_ENDPOINTS) "
        "and init_parallel_env")


__all__ = ["global_scatter", "global_gather", "get_cluster_from_args"]
