"""Weight conversion into (and out of) the port's parameter trees."""

from flasht5_tpu_torch.convert.from_jax import (params_from_numpy,
                                                params_to_numpy)

__all__ = ["params_from_numpy", "params_to_numpy"]
