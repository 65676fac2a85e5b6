"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    The card is the default; the CPU runs only when asked for.  Asking for
    the card without CUDA raises instead of quietly running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def codec_device(ec) -> torch.device:
    """The device a codec runs on, where the storage layer keeps what it
    holds for it (the cache tier): the ``cuda`` plugin's (the card, or the
    CPU when its profile says ``device=cpu``); the CPU for a host codec
    (``plugin="jerasure"``, which is how a caller asks for the CPU) or a
    replicated pool (no codec)."""
    dev = getattr(ec, "_device", None)
    return dev if dev is not None else torch.device("cpu")
