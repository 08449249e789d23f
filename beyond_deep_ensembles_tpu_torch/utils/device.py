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
    config is fp32 throughout; and makes cuBLAS accumulate bf16 products in
    fp32 (no reduced-precision reduction), as the JAX package's bf16
    products accumulate. The flags are process-wide.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_count() -> int:
    """The devices this process sees (JAX ``jax.device_count()``): the
    visible cards, and one where there is none."""
    return max(1, torch.cuda.device_count())


def refuse_multi_device(config: dict, flags=("data_parallel", "ring_shard")) -> None:
    """The multi-device flags of a config: on one device they are no-ops, as
    in the JAX package, which gates every use on ``jax.device_count() > 1``;
    with more than one visible card the port has no mesh yet and raises."""
    n = device_count()
    if n == 1:
        return
    for flag in flags:
        if config.get(flag):
            raise NotImplementedError(f"{flag} over {n} visible cards: not ported yet (ROADMAP item 18)")


def refuse_more_cards(device: torch.device, what: str) -> None:
    """Raises on a card when more than one is visible: ``what`` (a batch the
    JAX package shards over every device) has no mesh in the port yet."""
    if device.type == "cuda" and device_count() > 1:
        raise NotImplementedError(f"{what} over {device_count()} visible cards: not ported yet (ROADMAP item 18)")
