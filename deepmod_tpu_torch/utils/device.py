"""Device selection for the port's entry points.

Entry points default to ``"cuda"``; the CPU is used only when the caller
asks for it (``device="cpu"``, ``--device cpu``). A CUDA request on a
machine without a usable GPU raises instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA GPU is "
                "available; pass device='cpu' (--device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use cuda or cpu")
    return dev
