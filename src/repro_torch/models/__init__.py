from repro_torch.models.dist import NO_MESH, MeshInfo, shard
from repro_torch.models.model import (forward_decode, forward_prefill,
                                      forward_train, init_cache,
                                      set_cache_length)
from repro_torch.models.params import from_jax_params, init_params

__all__ = ["MeshInfo", "NO_MESH", "forward_decode", "forward_prefill",
           "forward_train", "from_jax_params", "init_cache", "init_params",
           "set_cache_length", "shard"]
