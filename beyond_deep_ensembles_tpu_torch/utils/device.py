"""Where an entry point runs.

Port-only module: the JAX package picks its backend globally. Here every
entry point takes ``device`` and resolves it once. Under ``torchrun`` each
rank takes its own card, ``cuda:LOCAL_RANK``; the device count is the
process group's world size (``parallel/mesh.py``).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

from ..parallel import mesh


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """CUDA unless the caller asks for the CPU; raises when CUDA is asked for
    (or defaulted to) and absent, never falling back to the CPU.

    On CUDA this also pins fp32 math to full precision: cuDNN convolutions
    default to TF32 (about three decimal digits), while the JAX reference
    config is fp32 throughout; and makes cuBLAS accumulate bf16 products in
    fp32 (no reduced-precision reduction), as the JAX package's bf16
    products accumulate. The flags are process-wide.

    Under ``torchrun`` (``LOCAL_RANK`` set) the default, or a bare
    ``"cuda"``, is the rank's card ``cuda:LOCAL_RANK``, made the current
    device; a card the caller names by index wins over ``LOCAL_RANK`` (two
    ranks on one card, as ``chip_smoke.py`` runs them).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None and "LOCAL_RANK" in os.environ:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        if dev.index is not None:
            torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_count() -> int:
    """The devices of the run (JAX ``jax.device_count()``): the process
    group's world size, 1 without a group."""
    return mesh.world_size()
