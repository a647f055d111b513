"""paddle.flops (port of ``paddle_tpu/hapi/flops.py``): the FLOPs of one
forward pass.

The reference asks XLA's ``cost_analysis`` of the compiled forward, which
counts every op, elementwise ones included. The port counts with
``torch.utils.flop_counter.FlopCounterMode``, which counts the products
(matmuls, convolutions, attention) at two FLOPs a multiply-add and nothing
elementwise, plus the flash kernels' own tally. The two are not the same
count: on a convolutional network the port's is the smaller by the
elementwise work (``tests/test_torch_hapi.py`` states the ratio).
"""
from __future__ import annotations

import torch


def flops(net, input_size, custom_ops=None, print_detail=False):
    """FLOPs of one forward pass at ``input_size`` (a list, with the batch
    dimension), on zeros placed where ``net``'s parameters are."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.kernels import flash_attention as fa

    shape = tuple(int(s) for s in input_size)
    params = list(net.parameters())
    dev = params[0].device if params else torch.device("cpu")
    dtype = params[0].dtype if params else torch.float32
    x = torch.zeros(shape, dtype=dtype, device=dev)
    # the forward leaves the network as it found it (a train-mode
    # BatchNorm would fold the zeros into its running statistics)
    saved = [(b, b.detach().clone()) for b in net.buffers()]
    k0 = sum(fa.flops.values())
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            net(x)
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)
    total = fc.get_total_flops() + sum(fa.flops.values()) - k0
    if print_detail:
        n_params = sum(p.numel() for p in params)
        print(f"Total Flops: {total:,.0f}  Total Params: {n_params:,}")
    return int(total)
