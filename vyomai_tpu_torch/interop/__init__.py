from .from_jax import (  # noqa: F401
    decoder_params_from_jax, encoder_params_from_jax, params_from_jax,
    tree_from_torch, vit_params_from_jax)
