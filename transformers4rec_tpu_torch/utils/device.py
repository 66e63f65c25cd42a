"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU by name: a
machine without CUDA raises instead of carrying on silently on the CPU. In
a ``torch.distributed`` world each rank's GPU is its local rank's card
(``LOCAL_RANK``, as ``torchrun`` sets it, else the global rank) modulo the
cards the machine has: ranks beyond the count share cards.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def local_cuda_device() -> torch.device:
    """``cuda:<local rank mod cards>`` in an initialised world, else
    ``cuda``."""
    if dist.is_available() and dist.is_initialized() and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` and ``"cuda"`` mean ``local_cuda_device()``: card 0 outside
    a world, the rank's own card inside one. A CUDA device on a machine
    without CUDA raises ``RuntimeError``; ``"cpu"`` is always allowed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = local_cuda_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """Keep float32 matrix products in full float32 on the GPU.

    The reference scores items with an f32 x f32 product
    (model/prediction_task.py:568); TF32 keeps about three decimal digits
    and would reorder near-tied items in the top-k.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """Device of a module's first parameter (``None`` when it has none)."""
    for p in module.parameters():
        return p.device
    return None
