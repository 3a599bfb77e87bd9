from repro_torch.models.model import (forward_decode, forward_prefill,
                                      init_cache, set_cache_length)
from repro_torch.models.params import from_jax_params, init_params

__all__ = ["forward_decode", "forward_prefill", "from_jax_params",
           "init_cache", "init_params", "set_cache_length"]
