"""PyTorch + CUDA port of ``vyomai_tpu`` for NVIDIA Hopper.

Same sub-package layout as the JAX package. Plain tensor code is PyTorch;
each Pallas kernel of the JAX package on a ported path is a hand-written
CUDA kernel under ``csrc/`` (built with nvcc at first use). This package
never imports jax. Entry points build on the CUDA card unless the caller
passes ``device="cpu"`` (or another device).
"""

from .config import (DeepseekV3Config, EncoderConfig,  # noqa: F401
                     Lfm2MoeConfig, QwenConfig, VisionConfig)
from .generation import (  # noqa: F401
    generate, generate_hf, generate_multimodel, generate_seq2seq,
    generate_until, GreedyProcessor, KeywordsStoppingCriteria,
    MinPProcessor, MultinomialProcessor, NucleusProcessor,
    TopKNucleusProcessor, TopKProcessor)
from .layers.kv_cache import (  # noqa: F401
    DynamicCache, DynamicCacheOne, StaticCache, StaticCacheOne, init_cache)
from .models.decoder import DecoderModel  # noqa: F401
from .models.deepseek_v3 import DeepseekV3ForCausalLM  # noqa: F401
from .models.encoder import EncoderForMaskedLM, EncoderModel  # noqa: F401
from .models.lfm2 import Lfm2MoeForCausalLM  # noqa: F401
from .models.qwen import ModelForCausalLM  # noqa: F401
from .models.vision import Vit  # noqa: F401
from .quant import dequantize_model, quantize_model  # noqa: F401
from .serving import ContinuousBatchEngine  # noqa: F401
