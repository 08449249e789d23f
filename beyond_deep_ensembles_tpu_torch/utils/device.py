"""Where an entry point runs.

Port-only module: the JAX package picks its backend globally. Here every
entry point takes ``device`` and resolves it once.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """CUDA unless the caller asks for the CPU; raises when CUDA is asked for
    (or defaulted to) and absent, never falling back to the CPU.

    On CUDA this also pins fp32 math to full precision: cuDNN convolutions
    default to TF32 (about three decimal digits), while the JAX reference
    config is fp32 throughout. The flags are process-wide.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
