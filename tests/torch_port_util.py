"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
JAX model's weights exported as numpy, and the port model built from them."""
import numpy as np

from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     load_reference_state_dict)


def reference_state(jmodel):
    """The JAX model's ``state_dict()`` as float32 numpy arrays."""
    return {k: np.asarray(v, np.float32) for k, v in jmodel.state_dict().items()}


def port_of(jmodel, **config):
    """A CPU ``paddle_tpu_torch`` GPT (eval, no dropout) carrying the JAX
    GPT's weights, loaded by parameter name; ``config`` sets further
    ``GPTConfig`` fields."""
    cfg = GPTConfig(**{f: getattr(jmodel.config, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "max_position_embeddings")}, hidden_dropout=0.0,
        attention_dropout=0.0, **config)
    m = GPTForPretraining(cfg, device="cpu").eval()
    load_reference_state_dict(m, reference_state(jmodel))
    return m
