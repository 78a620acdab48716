"""Device resolution for the port's entry points.

The port runs on the card.  ``device=None`` means ``cuda`` and raises when
no card is present: there is no silent CPU fallback.  The CPU runs only
when a caller asks for it by name (the tests do, with ``device="cpu"``).
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as given, and a CUDA device without a card raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port's entry points run on "
            "the card by default — pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def sync_mode(device: torch.device, mode: int | str):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, then the mode
    before it; a no-op off the card, where the mode means nothing."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
