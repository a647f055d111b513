"""The public layers of ``paddle_tpu_torch.nn`` follow the port's device rule:
``cuda`` unless the caller passes ``device="cpu"``, and a ``RuntimeError``
naming ``device='cpu'`` when CUDA is missing — never a quiet CPU build."""
import pytest
import torch

from paddle_tpu_torch.nn import Embedding, LayerNorm, Linear

LAYERS = {
    "linear": lambda **kw: Linear(4, 3, **kw),
    "embedding": lambda **kw: Embedding(10, 4, **kw),
    "layer_norm": lambda **kw: LayerNorm(4, **kw),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_default_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LAYERS[name]()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_builds_on_cpu_when_asked(name):
    layer = LAYERS[name](device="cpu", dtype=torch.float32)
    params = list(layer.parameters())
    assert params and all(p.device.type == "cpu" for p in params)
    x = (torch.arange(2) if name == "embedding"
         else torch.ones(2, 4, dtype=torch.float32))
    assert layer(x).shape[0] == 2
