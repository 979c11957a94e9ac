"""Weight conversion into (and out of) the port's parameter trees: JAX
trees as numpy (`from_jax`), and HF T5 / FAT5 safetensors checkpoints
(`hf_import`, on the port's own `safetensors_file` reader and writer)."""

from flasht5_tpu_torch.convert.from_jax import (params_from_numpy,
                                                params_to_numpy)
from flasht5_tpu_torch.convert.hf_import import (hf_key_to_fat5,
                                                 load_fat5_safetensors,
                                                 load_hf_t5_safetensors,
                                                 params_to_fat5_state_dict,
                                                 state_dict_to_params,
                                                 validate_params)

__all__ = ["params_from_numpy", "params_to_numpy", "hf_key_to_fat5",
           "state_dict_to_params", "load_fat5_safetensors",
           "load_hf_t5_safetensors", "params_to_fat5_state_dict",
           "validate_params"]
