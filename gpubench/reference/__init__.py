"""The plain reference: for each model family a float32 PyTorch forward,
``<family>.py`` beside ``families/<family>.py`` (``dense.py``: RMSNorm,
SwiGLU, GQA, RoPE, optional per-head QK-norm, tied or untied head), on what
they share (``common.py``: the seeded weights again, its own int8 weight
quantizer, the reading of the served tokens' gaps). It imports nothing of
the program under test."""
