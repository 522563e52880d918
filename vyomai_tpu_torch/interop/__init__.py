from .from_jax import (  # noqa: F401
    decoder_params_from_jax, decoder_tree_from_torch, params_from_jax)
