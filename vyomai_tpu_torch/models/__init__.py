from .qwen import ModelForCausalLM  # noqa: F401
