from .convert import (ep_merge_state_dicts, ep_split_state_dict,
                      load_reference_state_dict, merge_state_dicts,
                      mp_layouts, pp_merge_state_dicts, pp_split_state_dict,
                      split_state_dict)
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieLayer, ErnieModel,
                    ErnieSelfAttention, ernie_3_base)
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt3_13b, gpt3_1p3b,
                  gpt_tiny)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel, RMSNorm,
                    apply_rope, llama_7b, llama_tiny)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "gpt_tiny",
           "gpt3_1p3b", "gpt3_13b", "load_reference_state_dict",
           "split_state_dict", "merge_state_dicts", "mp_layouts",
           "pp_split_state_dict", "pp_merge_state_dicts",
           "ep_split_state_dict", "ep_merge_state_dicts",
           "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP", "RMSNorm",
           "apply_rope", "llama_tiny", "llama_7b", "ErnieConfig",
           "ErnieForPretraining", "ErnieModel", "ErnieLayer",
           "ErnieSelfAttention", "ernie_3_base"]
