"""The model-parallel helper collectives (port of
``paddle_tpu/distributed/collective.py:364–444``), single-rank form.

The layers of ``fleet/meta_parallel/mp_layers.py`` call them around their
matmuls. With no group, or a group of one rank, each is what the
reference's is outside a bound ``mp`` axis: the identity, or, for
``_c_softmax_with_cross_entropy``, the plain per-row cross-entropy. A group
of more than one rank raises ``NotImplementedError``: the collectives over
``torch.distributed`` come with ROADMAP A11.
"""
from __future__ import annotations

__all__ = ["get_rank", "get_world_size", "_c_identity", "_mp_allreduce",
           "_c_split", "_c_concat", "_c_softmax_with_cross_entropy"]


def get_rank(group=None) -> int:
    """This process's rank: 0, the port running as one process
    (``paddle_tpu/distributed/parallel_env.py:101``)."""
    return 0


def get_world_size(group=None) -> int:
    """The group's rank count, else 1: one process (``parallel_env.py:107``;
    more than one comes with ROADMAP A11)."""
    return 1 if group is None else int(group.nranks)


def _nranks(group) -> int:
    return 1 if group is None else int(getattr(group, "nranks", 1))


def _single_rank(group, what: str) -> None:
    n = _nranks(group)
    if n > 1:
        raise NotImplementedError(
            f"{what} over a group of {n} ranks is not ported yet: ROADMAP "
            "A11 (distributed); only the single-rank form is")


def _c_identity(tensor, group=None):
    """Forward identity; backward all-reduce (column-parallel input)."""
    _single_rank(group, "_c_identity")
    return tensor


def _mp_allreduce(tensor, group=None):
    """Forward all-reduce; backward identity (row-parallel output)."""
    _single_rank(group, "_mp_allreduce")
    return tensor


def _c_split(tensor, group=None):
    """This rank's shard of the last axis (forward); all-gather (backward)."""
    _single_rank(group, "_c_split")
    return tensor


def _c_concat(tensor, group=None):
    """All-gather along the last axis (column-parallel output gather)."""
    _single_rank(group, "_c_concat")
    return tensor


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  ignore_index=-100):
    """Per-row softmax cross-entropy of logits whose class axis would be
    sharded over the group; rows labelled ``ignore_index`` give 0."""
    _single_rank(group, "_c_softmax_with_cross_entropy")
    from ..nn.functional.loss import cross_entropy

    return cross_entropy(logits, label, reduction="none",
                         ignore_index=ignore_index)
