"""The plain reference: a float32 PyTorch forward of the ``QwenConfig``
family (RMSNorm, SwiGLU, GQA, RoPE, optional per-head QK-norm, tied or
untied head) and its own int8 weight quantizer. It imports nothing of the
program under test."""
