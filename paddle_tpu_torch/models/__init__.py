from .convert import load_reference_state_dict
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt3_13b, gpt3_1p3b,
                  gpt_tiny)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTModel", "gpt_tiny",
           "gpt3_1p3b", "gpt3_13b", "load_reference_state_dict"]
