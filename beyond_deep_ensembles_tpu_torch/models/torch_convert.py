"""Load torchvision-layout checkpoints into the port's models.

Counterpart of ``beyond_deep_ensembles_tpu/models/torch_convert.py``
(``convert_torch_state_dict``, ``load_torch_backbone``). The reference
trains iWildCam and RxRx1 from a pretrained torchvision ``resnet50``
(experiments/iwildcam/models.py:171, rxrx1/models.py:21);
``ResNet50(torchvision=True)`` has its topology, so a saved ``state_dict``
loads into it. The port's layouts are PyTorch's (conv kernels OIHW, dense
kernels ``[out, in]``), so a tensor moves as it is; what is ported is the
JAX package's matching, so that both load the same tensor into the same
parameter:

  * running statistics, ``num_batches_tracked``, a reference Gaussian
    parameter's ``rho``, spectral-norm vectors ``_u`` / ``_v`` and the SNGP
    head's buffers are dropped (the benchmark's static BN uses batch
    statistics: reference iwildcam/models.py:53-55);
  * the rest falls in kind buckets: ``conv`` (4-d), ``dense`` (2-d), FRN's
    ``tau`` / ``beta`` / ``gamma`` (reshaped to ``(C,)``), ``scale`` (1-d
    weights), ``bias``, Rank-1 ``factor`` stacks (``<layer>.{s,r}.<i>.mean``
    by component) and per-component biases ``cbias`` (a 2-d ``.bias``);
  * the model's parameters, in module order (the order in which the JAX
    model creates them, and a torch ``nn.Sequential``'s state_dict order),
    each take the first unused tensor of their bucket with their shape;
    variational ``__grho`` / ``__mle`` parameters keep their init, and so does
    any parameter without a match (a head with another class count);
  * more than half the tensors unused raises (an architecture mismatch).
"""
from __future__ import annotations

import re
from typing import Dict

import torch
from torch import nn

_FRN_NAMES = ("tau", "beta", "gamma")
_RANK1_FACTOR_RE = re.compile(r"^(.*\.[sr])\.(\d+)\.mean$")


def _leaf_kind(name: str, leaf: torch.Tensor) -> str:
    """A port parameter's bucket (JAX ``_leaf_kind``: by name, then rank)."""
    base = name.rsplit(".", 1)[-1]
    if base.endswith(("__grho", "__mle", "_rho")) or base == "rho":
        return "skip"
    if base in ("s__gmean", "r__gmean"):
        return "factor"
    if base == "bias" and leaf.ndim == 2:
        return "cbias"
    for frn in _FRN_NAMES:
        if base == frn or base.startswith(frn + "__"):
            return frn
    if leaf.ndim >= 3:
        return "conv"
    if leaf.ndim == 2:
        return "dense"
    if base in ("scale", "weight"):
        return "scale"
    return "bias"


def _torch_kind(key: str, arr: torch.Tensor):
    """A state_dict tensor's bucket, or None where it is dropped (JAX
    ``_torch_kind``)."""
    if key.endswith("num_batches_tracked") or "running_" in key:
        return None
    base = key.rsplit(".", 1)[-1]
    if base == "rho" or base.endswith("_rho"):
        return None
    if base == "mu":
        key = key[: -len(".mu")]
        base = key.rsplit(".", 1)[-1]
    if base in ("_u", "_v"):
        return None
    if base == "bias" and arr.ndim == 2:
        return "cbias"
    if base in ("precision", "covariance", "seen_data", "feature_scale", "random_matrix") or ".rff." in key:
        return None
    for frn in _FRN_NAMES:
        if base in (frn, frn + "_mu"):
            return frn
    if arr.ndim == 4:
        return "conv"
    if arr.ndim == 2:
        return "dense"
    if arr.ndim == 1:
        return "bias" if key.endswith(".bias") else "scale"
    return None


def convert_torch_state_dict(state_dict: Dict[str, torch.Tensor], module: nn.Module) -> Dict[str, torch.Tensor]:
    """``{parameter name: tensor}`` for every parameter of ``module`` that a
    tensor of ``state_dict`` fills (see the module docstring), fp32 on the
    CPU."""
    buckets: dict = {k: [] for k in ("conv", "dense", "scale", "bias", "factor", "cbias", *_FRN_NAMES)}
    total = 0
    factor_groups: Dict[str, list] = {}
    for k in state_dict:
        m = _RANK1_FACTOR_RE.match(k)
        if m:
            factor_groups.setdefault(m.group(1), []).append(k)

    def fp32(v):
        return torch.as_tensor(v).detach().to("cpu", torch.float32)

    for k, v in state_dict.items():
        m = _RANK1_FACTOR_RE.match(k)
        if m:
            group = factor_groups[m.group(1)]
            if k != group[0]:
                continue  # stacked with the first component
            comps = sorted(group, key=lambda kk: int(_RANK1_FACTOR_RE.match(kk).group(2)))
            buckets["factor"].append([torch.stack([fp32(state_dict[kk]) for kk in comps]), False])
            total += 1
            continue
        arr = fp32(v)
        kind = _torch_kind(k, arr)
        if kind is None:
            continue
        if kind in _FRN_NAMES:
            arr = arr.reshape(-1)  # [1, C, 1, 1] -> (C,)
        buckets[kind].append([arr, False])
        total += 1

    out = {}
    for name, leaf in module.named_parameters():
        for entry in buckets.get(_leaf_kind(name, leaf), ()):
            if not entry[1] and entry[0].shape == leaf.shape:
                out[name], entry[1] = entry[0], True
                break
    unmatched = sum(1 for b in buckets.values() for e in b if not e[1])
    if total and unmatched > total * 0.5:
        raise ValueError(f"conversion matched too little: {unmatched}/{total} torch tensors unused — "
                         "architecture mismatch?")
    return out


@torch.no_grad()
def load_torch_backbone(path: str, module: nn.Module) -> nn.Module:
    """``module``'s parameters filled in place from the checkpoint at
    ``path`` (a ``state_dict``, or a dict holding one under
    ``"state_dict"``), read with ``torch.load(weights_only=True)``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    params = dict(module.named_parameters())
    for name, value in convert_torch_state_dict(sd, module).items():
        params[name].copy_(value)
    return module
