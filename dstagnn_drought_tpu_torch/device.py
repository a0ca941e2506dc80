"""Device and dtype resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
card they raise instead of dropping silently to the CPU. float32 compute is
full float32: TF32 is switched off for matmuls and for cuDNN convolutions
(the latter is on by default in PyTorch).
"""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: --device cpu) to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``TrainingConfig.compute_dtype`` → torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute_dtype {name!r}") from None
