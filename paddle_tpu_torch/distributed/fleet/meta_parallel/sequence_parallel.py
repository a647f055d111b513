"""Sequence parallelism: ring attention and Ulysses (port of
``paddle_tpu/distributed/fleet/meta_parallel/sequence_parallel.py``).

Each function takes a ``collective.Group`` where the reference takes a
mesh axis name inside ``shard_map``; every rank of the group calls it on
its own sequence shard, (B, T_local, H, D).

* ``ring_attention``: each rank keeps its Q shard while the K/V blocks
  travel the ring (the shift of ``collective._ring_shift``, the
  reference's ``lax.ppermute`` with ``perm = [(i, (i - 1) % n)]``), in
  their input dtype; the softmax is merged online (running max and sum), a
  causal future block is skipped (the shift still runs: every rank takes
  part in it), and the sum is floored at 1e-30. The backward is written
  out (``_RingAttention``): the reference differentiates its scan, whose
  every rank runs one program; here each rank's autograd graph differs
  where a block is skipped, so the backward walks the ring itself with
  the dK/dV accumulators travelling beside the blocks, from the saved
  log-sum-exp (the flash backward's algebra). ``_block_attn`` processes Q in
  chunks of at most 512 rows with the scores in float32 and the mask built
  per chunk, so the peak score block is (C, T_local). Its products are
  ``torch.matmul`` (the reference's are einsums, not a Pallas kernel):
  the operands are upcast to float32, which holds bf16 values exactly, and
  the probabilities are rounded to V's dtype first, as the reference's
  ``p.astype(v.dtype)``.
* ``ulysses_attention``: a tiled all-to-all turns the sequence shard into
  a head shard (``collective._all_to_all_tiled``, whose backward is the
  reverse exchange), the full-sequence attention runs locally on 1/n of the
  heads (``_local_attention``: ``flash_attention_array`` for D <= 256 and
  D % 8 == 0, which is the CUDA kernel on the card and its plain version on
  the CPU; the einsum form otherwise), and a second all-to-all turns it
  back.
* ``split_sequence`` (this rank's slice), ``split_batch`` (a training
  batch's inputs cut by their specs), ``gather_sequence`` (tiled
  all-gather, reduce-scatter backward) and ``RingAttention``.

Over a group of one rank the exchanges are identities.
"""
from __future__ import annotations

import math

import torch

from ...collective import _all_gather_tiled, _all_to_all_tiled
from ...collective import _shift as _c_shift

_Q_CHUNK = 512  # the score block is (C, T_local): memory follows C * T


def _chunk_size(t: int) -> int:
    """The largest chunk <= 512 on the halving ladder down to 64 that
    divides t; t itself when none does."""
    c = _Q_CHUNK
    while c >= 64:
        if t >= c and t % c == 0:
            return c
        c //= 2
    return t


def _nranks(group) -> int:
    return group.nranks if group is not None else 1


def _rank(group) -> int:
    return max(group.rank, 0) if group is not None else 0


def _block_attn(q, k, v, mask_fn=None, scale=None):
    """One Q block against one K/V block: (out unnormalized (B, T, H, D)
    f32, running max m (B, H, T), sum l (B, H, T)). ``mask_fn(q_start,
    q_len) -> (q_len, T_kv) bool`` builds each chunk's mask."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    T = q.shape[1]
    C = _chunk_size(T)
    kh = k.float().permute(0, 2, 3, 1)  # (B, H, D, T_kv)
    vh = v.permute(0, 2, 1, 3)  # (B, H, T_kv, D)
    os, ms, ls = [], [], []
    for start in range(0, T, C):
        qc = q[:, start:start + C].float().permute(0, 2, 1, 3)  # (B,H,C,D)
        s = torch.matmul(qc, kh) * scale
        if mask_fn is not None:
            s = s.masked_fill(~mask_fn(start, qc.shape[2])[None, None],
                              -1e30)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        o = torch.matmul(p.to(v.dtype).float(), vh.float())  # (B,H,C,D)
        os.append(o.permute(0, 2, 1, 3))
        ms.append(m)
        ls.append(l)
    if len(os) == 1:
        return os[0], ms[0], ls[0]
    return torch.cat(os, 1), torch.cat(ms, -1), torch.cat(ls, -1)


def _ring_mask(causal, me, kv_idx, t_local, dev):
    if not causal:
        return None

    def mask_fn(q_start, q_len):
        qpos = me * t_local + q_start + torch.arange(q_len, device=dev)
        kpos = kv_idx * t_local + torch.arange(t_local, device=dev)
        return qpos[:, None] >= kpos[None, :]

    return mask_fn


def _ring_forward(q, k, v, group, causal):
    """(out in q's dtype, lse (B, H, T) f32) of the ring over ``group``."""
    n, me = _nranks(group), _rank(group)
    t_local = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    B, T, H, D = q.shape
    dev = q.device
    o = torch.zeros(B, T, H, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, T), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, T, dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for step in range(n):
        kv_idx = (me + step) % n
        if not causal or kv_idx <= me:  # a future block is all masked
            o_b, m_b, l_b = _block_attn(
                q, k_cur, v_cur, _ring_mask(causal, me, kv_idx, t_local,
                                            dev), scale)
            m_new = torch.maximum(m, m_b)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_b - m_new)
            o = o * alpha.transpose(-1, -2)[..., None] \
                + o_b * beta.transpose(-1, -2)[..., None]
            l = l * alpha + l_b * beta
            m = m_new
        if step < n - 1:
            k_cur = _shift(k_cur, group, 1)
            v_cur = _shift(v_cur, group, 1)
    lf = torch.clamp_min(l, 1e-30)
    out = (o / lf.transpose(-1, -2)[..., None]).to(q.dtype)
    return out, m + torch.log(lf)


def _shift(x, group, step):
    return x if _nranks(group) == 1 else _c_shift(x, group, step)


class _RingAttention(torch.autograd.Function):
    """The ring with its own backward: every rank runs the same sequence of
    shifts in both passes (autograd's order over a graph that differs from
    rank to rank, as the causal skip makes it, could pair one rank's send
    with another's other receive). The backward walks the ring again: each
    K/V block's dK/dV accumulator travels with it and takes each rank's
    share, then one more shift brings it home."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        with torch.no_grad():
            out, lse = _ring_forward(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, me = _nranks(group), _rank(group)
        B, T, H, D = q.shape
        dev = q.device
        scale = 1.0 / math.sqrt(D)
        C = _chunk_size(T)
        dof = do.float()
        delta = (dof * out.float()).sum(-1).transpose(1, 2)  # (B, H, T)
        dq = torch.zeros(B, T, H, D, dtype=torch.float32, device=dev)
        k_cur, v_cur = k, v
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        for step in range(n):
            kv_idx = (me + step) % n
            if not causal or kv_idx <= me:
                mask_fn = _ring_mask(causal, me, kv_idx, k.shape[1], dev)
                kh = k_cur.float().permute(0, 2, 1, 3)  # (B, H, Tk, D)
                vh = v_cur.permute(0, 2, 1, 3)
                for start in range(0, T, C):
                    sl = slice(start, start + C)
                    qc = q[:, sl].float().permute(0, 2, 1, 3)  # (B,H,C,D)
                    s = torch.matmul(qc, kh.transpose(-1, -2)) * scale
                    if mask_fn is not None:
                        s = s.masked_fill(~mask_fn(start, qc.shape[2])[None,
                                                                       None],
                                          -1e30)
                    p = torch.exp(s - lse[:, :, sl, None])
                    doc = dof[:, sl].permute(0, 2, 1, 3)  # (B, H, C, D)
                    dv_cur += torch.matmul(p.to(v.dtype).float()
                                           .transpose(-1, -2),
                                           doc).permute(0, 2, 1, 3)
                    dp = torch.matmul(doc, vh.float().transpose(-1, -2))
                    ds = p * (dp - delta[:, :, sl, None]) * scale
                    dq[:, sl] += torch.matmul(ds, kh).permute(0, 2, 1, 3)
                    dk_cur += torch.matmul(ds.transpose(-1, -2),
                                           qc).permute(0, 2, 1, 3)
            if step < n - 1:
                k_cur = _shift(k_cur, group, 1)
                v_cur = _shift(v_cur, group, 1)
            dk_cur = _shift(dk_cur, group, 1)
            dv_cur = _shift(dv_cur, group, 1)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None,
                None)


def ring_attention(q, k, v, group=None, causal: bool = False):
    """q, k, v (B, T_local, H, D): this rank's sequence shard; returns its
    (B, T_local, H, D) rows of the attention over the whole sequence."""
    return _RingAttention.apply(q, k, v, group, bool(causal))


def ulysses_attention(q, k, v, group=None, causal: bool = False):
    """q, k, v (B, T_local, H, D) with H divisible by the group's size:
    sequence shard -> head shard, local attention, back."""
    def seq_to_heads(x):  # (B, T/n, H, D) -> (B, T, H/n, D)
        return _all_to_all_tiled(x, group, 2, 1)

    def heads_to_seq(x):  # (B, T, H/n, D) -> (B, T/n, H, D)
        return _all_to_all_tiled(x, group, 1, 2)

    o = _local_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                         causal)
    return heads_to_seq(o).to(q.dtype)


def _local_attention(qg, kg, vg, causal):
    """The full-sequence attention of the Ulysses step: the flash kernels
    when the head dimension tiles (D <= 256, D % 8 == 0), else the einsum
    form."""
    from ....ops.kernels.flash_attention import flash_attention_array

    d = qg.shape[-1]
    if d <= 256 and d % 8 == 0:
        return flash_attention_array(qg, kg, vg, causal=causal)
    s = torch.einsum("bqhd,bkhd->bhqk", qg, kg) * (1.0 / math.sqrt(d))
    if causal:
        T = s.shape[-1]
        keep = torch.ones(T, T, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vg)


def split_sequence(x, group=None, seq_axis=1):
    """This rank's slice of ``x`` along ``seq_axis``, whose length the
    group's size must divide."""
    n = _nranks(group)
    if x.shape[seq_axis] % n:
        raise ValueError(f"split_sequence: dim {seq_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    size = x.shape[seq_axis] // n
    return x.narrow(seq_axis, _rank(group) * size, size)


def _names_sp(entry) -> bool:
    return entry == "sp" or (isinstance(entry, (tuple, list))
                             and "sp" in entry)


def split_batch(batch, group=None, specs=None):
    """This rank's sequence shard of each input of a training batch.
    ``specs[i]`` (an engine's ``batch_specs``: one entry a dimension, each
    None, an axis name or a tuple of them) names the dimension of input i
    that is cut over ``group``, the one whose entry is or holds ``"sp"``;
    an input whose spec names no ``"sp"`` is kept whole. Without a spec an
    input of two or more dimensions is (batch, sequence, ...) and is cut
    along dim 1; those inputs must then agree on that length."""
    batch = list(batch)
    if _nranks(group) == 1:
        return batch
    specs = list(specs or ())
    dims = []
    for i, b in enumerate(batch):
        if i < len(specs):
            spec = tuple(specs[i] or ())
            dims.append(next((d for d, e in enumerate(spec)
                              if _names_sp(e)), None))
        else:
            dims.append(1 if b.dim() >= 2 else None)
    lengths = {batch[i].shape[1] for i in range(len(batch))
               if i >= len(specs) and dims[i] is not None}
    if len(lengths) > 1:
        raise ValueError(
            f"split_batch: the inputs without a spec differ in dim 1 "
            f"({sorted(lengths)}); pass batch_specs naming each input's "
            "sequence dimension (\"sp\")")
    return [b if d is None else split_sequence(b, group, d)
            for b, d in zip(batch, dims)]


def gather_sequence(x, group=None, seq_axis=1):
    """Every rank's ``x`` concatenated along ``seq_axis``."""
    return _all_gather_tiled(x, group, seq_axis)


def sp_group():
    """The hybrid communicate group's sequence group when ``fleet.init``
    gave it more than one rank, else None."""
    from ..base.fleet_base import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    g = hcg.get_sequence_parallel_group() if hcg is not None else None
    return g if g is not None and g.nranks > 1 else None


class RingAttention:
    """Layer-style wrapper holding the group (default: the hybrid
    communicate group's sequence group); with one rank it is the exact
    attention, as the reference's single-device path."""

    def __init__(self, group=None, causal=True):
        self.group = group
        self.causal = causal

    def __call__(self, q, k, v):
        group = self.group if self.group is not None else sp_group()
        if _nranks(group) > 1:
            return ring_attention(q, k, v, group, self.causal)
        from ....nn.functional.attention import scaled_dot_product_attention

        return scaled_dot_product_attention(q, k, v, is_causal=self.causal)


__all__ = ["ring_attention", "ulysses_attention", "split_sequence",
           "split_batch", "gather_sequence", "RingAttention", "sp_group"]
