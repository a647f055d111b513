"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
JAX model's weights exported as numpy, and the port model built from them."""
import dataclasses

import numpy as np

from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     LlamaConfig, LlamaForCausalLM,
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


def port_of_llama(jmodel):
    """A CPU ``paddle_tpu_torch`` Llama (eval) carrying the JAX Llama's
    weights, loaded by parameter name; its config copies the reference's."""
    cfg = LlamaConfig(**{f.name: getattr(jmodel.model.config, f.name)
                         for f in dataclasses.fields(LlamaConfig)})
    m = LlamaForCausalLM(cfg, device="cpu").eval()
    load_reference_state_dict(m, reference_state(jmodel))
    return m
