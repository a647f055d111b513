"""paddle.text — text domain API (port of ``paddle_tpu/text/__init__.py``).

Parity: reference ``python/paddle/text/`` (datasets, ``FasterTokenizer``
and the viterbi_decode op ``paddle/fluid/operators/viterbi_decode_op.h``).
The decode is the reference's dynamic program as plain tensor code on the
inputs' device, one step a position (the reference runs it as a
``lax.scan``; it is not a kernel).
"""
from __future__ import annotations

import torch

from ..core.tensor import to_tensor
from .datasets import (Conll05st, Imdb, Imikolov, Movielens,  # noqa: F401
                       UCIHousing, WMT14, WMT16)
from .faster_tokenizer import FasterTokenizer  # noqa: F401

__all__ = ["viterbi_decode", "ViterbiDecoder", "FasterTokenizer", "Imdb",
           "Imikolov", "UCIHousing", "Conll05st", "Movielens", "WMT14",
           "WMT16"]


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


@torch.no_grad()
def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """Batched Viterbi (reference text/viterbi_decode.py ->
    viterbi_decode_op).

    potentials: (B, T, N) emission scores; transition_params: (N, N), or
    (N + 2, N + 2) with the BOS row at -2 and the EOS column at -1 under
    ``include_bos_eos_tag``; lengths: (B,). Returns (scores (B,), paths
    (B, T) int64). Positions past a sequence's length keep its last tag.
    Sums are taken in the reference's order, so the paths are exact and
    the scores the same floats; ties take the first index, as
    ``jnp.argmax`` does.
    """
    emis = _tensor(potentials)
    trans = _tensor(transition_params).to(emis.device)
    lens = _tensor(lengths).to(emis.device)
    B, T, N = emis.shape
    alpha = emis[:, 0]
    if include_bos_eos_tag:
        alpha = alpha + trans[-2, :N][None, :]  # BOS row
    step_trans = trans[None, :N, :N]
    # live[t - 1]: which rows still run at step t
    live = (torch.arange(1, T, device=emis.device)[:, None]
            < lens[None, :])[:, :, None]
    backs = []
    for t in range(1, T):
        scores = alpha[:, :, None] + step_trans + emis[:, t][:, None, :]
        best = torch.amax(scores, dim=1)
        backs.append(torch.argmax(scores, dim=1))
        alpha = torch.where(live[t - 1], best, alpha)
    if include_bos_eos_tag:
        alpha = alpha + trans[:N, -1][None, :]  # EOS column
    last = torch.argmax(alpha, dim=-1)
    score = torch.amax(alpha, dim=-1)
    path = [last]
    tag = last
    for t in range(T - 1, 0, -1):
        prev = backs[t - 1].gather(1, tag[:, None])[:, 0]
        tag = torch.where(live[t - 1, :, 0], prev, tag)
        path.append(tag)
    return score, torch.stack(path[::-1], dim=1)


class ViterbiDecoder:
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include)
