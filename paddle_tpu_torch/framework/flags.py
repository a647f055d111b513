"""Global flag registry (the ``FLAGS_serve_*`` entries the serving slice reads).

Same names, defaults and ``FLAGS_*`` environment pickup as the reference's
``paddle_tpu/framework/flags.py``; ``set_flags`` rejects unknown names with a
did-you-mean hint instead of creating dead flags.
"""
from __future__ import annotations

import difflib
import os
from typing import Dict

_FLAGS: Dict[str, object] = {
    # Serving engine defaults: KV block size in tokens, total preallocated
    # blocks in the pool (block 0 is the reserved trash block), the decode
    # batch-width ceiling (bucketed in powers of two up to this), the fixed
    # prefill batch width, the per-sequence length cap (clamped to the
    # model's max_position_embeddings), and the weight-only int8 path.
    # EngineConfig fields override per engine.
    "FLAGS_serve_block_size": 16,
    "FLAGS_serve_num_blocks": 512,
    "FLAGS_serve_max_batch": 64,
    "FLAGS_serve_prefill_batch": 4,
    "FLAGS_serve_max_seq_len": 2048,
    "FLAGS_serve_int8": False,
    # Serving kernels: FLAGS_serve_paged_kernel routes decode attention
    # through the paged-attention kernel (reads K/V straight from the pool
    # blocks); FLAGS_serve_int8_kernel keeps the int8 LM-head weight
    # quantized end to end through the fused int8 matmul kernel.
    "FLAGS_serve_paged_kernel": False,
    "FLAGS_serve_int8_kernel": False,
}

for _k, _cur in list(_FLAGS.items()):
    if _k in os.environ:
        _v = os.environ[_k]
        if isinstance(_cur, bool):
            _FLAGS[_k] = _v.lower() in ("1", "true", "yes")
        elif isinstance(_cur, int):
            _FLAGS[_k] = int(_v)
        else:
            _FLAGS[_k] = _v


def set_flags(flags: dict) -> None:
    for k, v in flags.items():
        if k not in _FLAGS:
            hint = difflib.get_close_matches(k, _FLAGS, n=1)
            raise KeyError(
                f"unknown flag {k!r}"
                + (f"; did you mean {hint[0]!r}?" if hint else ""))
        _FLAGS[k] = v


def get_flags(flags) -> dict:
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}


def flag(name, default=None):
    return _FLAGS.get(name, default)
