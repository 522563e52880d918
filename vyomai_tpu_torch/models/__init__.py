from .decoder import DecoderModel  # noqa: F401
from .qwen import ModelForCausalLM  # noqa: F401
