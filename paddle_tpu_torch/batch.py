"""paddle.batch — the v1 batch-reader decorator (port of
``paddle_tpu/batch.py``; reference python/paddle/batch.py): wraps a sample reader creator into a batch reader
creator. Kept for v1 script compatibility; new code uses paddle.io.DataLoader.
"""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    batch_size = int(batch_size)
    if batch_size <= 0:
        raise ValueError(f"batch_size should be positive, got {batch_size}")

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
