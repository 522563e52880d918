from .decoder import DecoderModel  # noqa: F401
from .encoder import EncoderForMaskedLM, EncoderModel  # noqa: F401
from .qwen import ModelForCausalLM  # noqa: F401
from .vision import Vit  # noqa: F401
