"""Masking sentinel shared by the port's attention code."""

import torch

# torch.finfo(float32).min — the same additive mask constant as
# ``vyomai_tpu.core.masks.NEG_INF``.
NEG_INF = float(torch.finfo(torch.float32).min)
