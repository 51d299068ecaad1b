"""Device resolution for the port's entry points.

Every entry point that creates tensors takes ``device=None``, which means the
card.  Asking for the card where there is none raises: the port never carries
on quietly on the CPU.  Callers that want the CPU (the tests) say so.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded generator on ``device`` (torch draws on the generator's
    device, so CPU and CUDA tensors need generators of their own)."""
    return torch.Generator(device=device).manual_seed(seed)
