"""The device an entry point builds on when the caller names none."""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card. With
    no card, ``None`` raises instead of quietly building on the CPU: pass
    ``device="cpu"`` to run there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            'device="cpu" to build on the CPU')
    return torch.device("cuda")
