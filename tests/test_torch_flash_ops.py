"""The flash kernels as PyTorch operators
(``torch.ops.paddle_tpu_torch.flash_attention_fwd``, ``_dq``, ``_dkv``;
``paddle_tpu_torch/ops/kernels/flash_attention.py``), on the CPU.

- Each operator's CPU implementation equals the plain versions
  (``flash_attention_plain``, ``flash_attention_bwd_plain``) bit for bit,
  in float32 and bfloat16, and so do the gradients of
  ``flash_attention_array`` (the forward's registered backward: delta,
  then the dQ and dK/dV operators).
- ``torch.library.opcheck``: the schemas, the fake implementations against
  the real ones and the autograd registration.
- Under ``torch.export`` with a symbolic batch and length, the fake
  implementation gives O (B, T, H, D) and the LSE (B, H, T) in those
  symbols, and the exported program at other sizes equals the eager call.
- A device that is neither the CPU nor CUDA raises; no launch is counted on
  the CPU.
"""
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention as FA

OPS = torch.ops.paddle_tpu_torch


def _qkv(B, T, Tk, H, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, t, H, D, generator=g).to(dtype)
                   for t in (T, Tk, Tk, T))
    return q, k, v, do


CASES = [(2, 24, 24, 2, 16, True), (1, 17, 40, 3, 32, False),
         (1, 33, 33, 1, 64, True)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,Tk,H,D,causal", CASES)
def test_cpu_implementations_are_the_plain_versions(B, T, Tk, H, D, causal,
                                                    dtype):
    q, k, v, do = _qkv(B, T, Tk, H, D, dtype)
    o, lse = OPS.flash_attention_fwd(q, k, v, causal, 0, 0)
    po, plse = FA.flash_attention_plain(q, k, v, causal)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert o.is_contiguous() and lse.is_contiguous()
    delta = FA._delta(do, o)
    dq = OPS.flash_attention_dq(q, k, v, do, lse, delta, causal)
    dk, dv = OPS.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    for got, want in zip((dq, dk, dv), FA.flash_attention_bwd_plain(
            q, k, v, do, o, lse, causal)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_array_gradients_are_the_plain_backward(dtype):
    q, k, v, do = _qkv(2, 20, 20, 2, 16, dtype, seed=1)
    K.reset_launch_counts()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FA.flash_attention_array(*leaves, causal=True)
    out.backward(do)
    o, lse = FA.flash_attention_plain(q, k, v, True)
    assert torch.equal(out.detach(), o)
    for leaf, want in zip(leaves, FA.flash_attention_bwd_plain(
            q, k, v, do, o, lse, True)):
        assert torch.equal(leaf.grad, want)
    assert not any(K.launch_counts().values())


def test_opcheck():
    q, k, v, do = _qkv(1, 12, 12, 2, 8, torch.float32, seed=2)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    torch.library.opcheck(OPS.flash_attention_fwd.default,
                          (q, k, v, True, 0, 0))
    o, lse = FA.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                      True)
    o, lse = o.contiguous(), lse.contiguous()
    delta = FA._delta(do, o)
    args = (q.detach(), k.detach(), v.detach(), do, lse, delta, True)
    torch.library.opcheck(OPS.flash_attention_dq.default, args)
    torch.library.opcheck(OPS.flash_attention_dkv.default, args)


class _Attn(torch.nn.Module):
    def forward(self, q, k, v):
        return OPS.flash_attention_fwd(q, k, v, True, 0, 0)


def test_fake_shapes_at_a_symbolic_batch_and_length():
    q, k, v, _ = _qkv(2, 16, 16, 2, 8, torch.float32, seed=3)
    B = torch.export.Dim("B", min=1)
    T = torch.export.Dim("T", min=2)
    dims = ({0: B, 1: T},) * 3
    ep = torch.export.export(_Attn(), (q, k, v), dynamic_shapes=dims)
    node = next(n for n in ep.graph.nodes
                if str(n.target) == "paddle_tpu_torch.flash_attention_fwd."
                                    "default")
    o, lse = node.meta["val"]
    sym_b, sym_t = (str(s) for s in o.shape[:2])
    assert o.shape[2:] == (2, 8) and lse.shape[1] == 2
    assert str(lse.shape[0]) == sym_b and str(lse.shape[2]) == sym_t
    assert not sym_b.isdigit() and not sym_t.isdigit()
    assert lse.dtype == torch.float32 and o.dtype == q.dtype
    run = ep.module()
    for shape in ((1, 5), (3, 29)):
        x = _qkv(shape[0], shape[1], shape[1], 2, 8, torch.float32, seed=4)
        got = run(*x[:3])
        want = OPS.flash_attention_fwd(*x[:3], True, 0, 0)
        assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_other_devices_raise():
    q = torch.empty(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        FA.flash_attention_array(q, q, q, causal=True)
    with pytest.raises(ValueError, match="unsupported device"):
        FA._route("flash_attention_dq", q)
