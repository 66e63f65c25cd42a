"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU by name: a
machine without CUDA raises instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device on a machine without CUDA
    raises ``RuntimeError``; ``"cpu"`` is always allowed."""
    dev = torch.device("cuda" if device is None else device)
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
