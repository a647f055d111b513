from .convert import load_reference_state_dict
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt3_13b, gpt3_1p3b,
                  gpt_tiny)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel, RMSNorm,
                    apply_rope, llama_7b, llama_tiny)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "gpt_tiny",
           "gpt3_1p3b", "gpt3_13b", "load_reference_state_dict",
           "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP", "RMSNorm",
           "apply_rope", "llama_tiny", "llama_7b"]
