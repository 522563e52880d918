from .decoder import DecoderModel  # noqa: F401
from .deepseek_v3 import DeepseekV3ForCausalLM  # noqa: F401
from .encoder import EncoderForMaskedLM, EncoderModel  # noqa: F401
from .lfm2 import Lfm2MoeForCausalLM  # noqa: F401
from .qwen import ModelForCausalLM  # noqa: F401
from .vision import Vit  # noqa: F401
