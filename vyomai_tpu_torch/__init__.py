"""PyTorch + CUDA port of ``vyomai_tpu`` for NVIDIA Hopper.

Same sub-package layout as the JAX package. Plain tensor code is PyTorch;
each Pallas kernel of the JAX package on a ported path is a hand-written
CUDA kernel under ``csrc/`` (built with nvcc at first use). This package
never imports jax.
"""

from .config import EncoderConfig, QwenConfig  # noqa: F401
from .models.decoder import DecoderModel  # noqa: F401
from .models.qwen import ModelForCausalLM  # noqa: F401
from .serving import ContinuousBatchEngine  # noqa: F401
