"""The Wilson et al. HMC posterior-sample baseline.

Counterpart of ``beyond_deep_ensembles_tpu/data/wilson.py`` (reference
src/wilson.py:22-57 with google-bnn-hmc): loads the published HMC sample
checkpoints and evaluates them into the "ground-truth" posterior predictive
that CIFAR's eval compares against (agreement and total variation,
experiments/cifar/cifar.py:105-121).

Checkpoints (reference src/wilson.py:47-56): one pickle a sample,
``$BDE_DATA_DIR/wilson_hmc/<dataset>/state-<i>.pkl``, a dict with
``params`` (a haiku resnet20_frn_swish tree) and ``net_state``, every leaf
with a leading 3-chain axis; the legacy layout ``wilson_hmc/chain<k>/*.pkl``
of unstacked trees is read too. Samples come file-major, chain-minor, as in
JAX. Each is converted once into the port's ``WilsonResNet20`` parameters by
a name map (haiku ``conv2_d{,_i}`` / ``frn{,_i}`` / ``linear`` -> ``conv_{i}``
/ ``frn_{i}`` / ``linear``; kernels HWIO -> OIHW, ``[in, out]`` -> ``[out,
in]``, FRN's ``(1, 1, 1, C)`` -> ``(C,)``) and the set is stacked on the
device.

Pickles are read with plain ``pickle`` under an unpickler that admits
only what dicts of numpy arrays need (numpy's array and dtype
reconstructors, ``_codecs.encode``, ``collections.OrderedDict``): a file
that needs any other class, a ``jax`` array or a haiku ``FlatMapping``
among them, raises an error naming the class and the file (the published
files hold numpy arrays in dicts). ``infer`` evaluates the samples one at a
time (JAX vmaps all of them at once); the log-probs are the same. With
nothing staged, the hermetic fallback draws 4 samples around the seed's
init, ``init + 0.05 * N(0, 1)``, from the port's generator: its values are
not JAX's (threefry), its count, shapes and scale are.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.resnet import WilsonResNet20
from ..tree import tree_stack
from ..utils.device import resolve_device
from .uci import data_dir

_NUMPY = {"_reconstruct", "ndarray", "dtype", "_frombuffer", "scalar"}
_OTHER = {("_codecs", "encode"), ("collections", "OrderedDict")}


class _NumpyUnpickler(pickle.Unpickler):
    def __init__(self, fh, path: str):
        super().__init__(fh)
        self.path = path

    def find_class(self, module, name):
        if (module.split(".")[0] == "numpy" and name in _NUMPY) or (module, name) in _OTHER:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{self.path} needs the class {module}.{name} to unpickle; the port reads dicts of numpy arrays only "
            f"(save the sample with its leaves as numpy arrays)")


def _load_pickle(path: str):
    with open(path, "rb") as fh:
        return _NumpyUnpickler(fh, path).load()


def _haiku_module_name(flax_name: str) -> str:
    """conv_0 -> conv2_d, conv_3 -> conv2_d_3, frn_0 -> frn, ..."""
    kind, idx = flax_name.rsplit("_", 1)
    base = {"conv": "conv2_d", "frn": "frn"}[kind]
    return base if idx == "0" else f"{base}_{idx}"


def convert_wilson_sample(haiku_params: dict, template) -> dict:
    """One haiku resnet20_frn_swish parameter tree -> the state dict of the
    port's ``WilsonResNet20`` ``template`` (a module or its state dict), by
    name (haiku: ``{'conv2_d{,_i}': {'w', 'b'}, 'frn{,_i}': {'tau', 'beta',
    'gamma'} each (1, 1, 1, C), 'linear': {'w', 'b'}}``, vendored
    models.py:76-176). A module key may carry a transform prefix
    (``res_net/~/conv2_d``), which is stripped. No shape guessing:
    identically shaped FRN leaves cannot cross-assign."""
    src = {k.split("/")[-1]: v for k, v in haiku_params.items()}
    names = template.state_dict() if isinstance(template, torch.nn.Module) else template
    hk_leaf = {"kernel": "w", "bias": "b", "tau": "tau", "beta": "beta", "gamma": "gamma"}
    out = {}
    for name, like in names.items():
        scope, leaf = name.rsplit(".", 1)
        if scope == "linear":
            module = "linear"
        elif scope.startswith(("conv_", "frn_")):
            module = _haiku_module_name(scope)
        else:
            raise ValueError(f"unexpected scope {scope!r} in the Wilson template")
        arr = np.asarray(src[module][hk_leaf[leaf]], np.float32)
        if leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            arr = arr.T
        out[name] = torch.from_numpy(np.array(arr.reshape(tuple(like.shape)), order="C"))
    return out


def _chain_count(params: dict) -> int:
    first = next(iter(params.values()))
    return _chain_count(first) if isinstance(first, dict) else int(np.shape(first)[0])


def _chain(params: dict, i: int) -> dict:
    return {k: _chain(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in params.items()}


class WilsonHMC:
    """Reference WilsonHMC (src/wilson.py:22-57): the posterior predictive
    of the published HMC chains on CIFAR-10 batches, on ``device`` (the
    card unless ``"cpu"``)."""

    def __init__(self, max_samples_per_chain: Optional[int] = None, seed: int = 0, dataset: str = "cifar10",
                 device=None):
        self.device = resolve_device(device)
        self.module = WilsonResNet20(10, activation="swish", generator=torch.Generator().manual_seed(seed))
        samples = self._load_samples(max_samples_per_chain, seed, dataset)
        self._stacked = {k: v.to(self.device) for k, v in tree_stack(samples).items()}
        self.n_samples = len(samples)
        self.module.to(self.device)

    def _load_samples(self, max_per_chain, seed, dataset) -> List[dict]:
        root = os.path.join(data_dir(), "wilson_hmc")
        samples: List[dict] = []

        # published layout: <root>/<dataset>/state-<i>.pkl, a 3-chain axis
        # on every leaf (reference wilson.py:47-56)
        pub_dir = os.path.join(root, dataset)
        if os.path.isdir(pub_dir):
            files = sorted((f for f in os.listdir(pub_dir) if re.match(r"state-\d+\.pkl$", f)),
                           key=lambda f: int(re.findall(r"\d+", f)[0]))
            if max_per_chain:
                files = files[:max_per_chain]
            for f in files:
                ckpt = _load_pickle(os.path.join(pub_dir, f))
                params = ckpt["params"] if isinstance(ckpt, dict) and "params" in ckpt else ckpt
                for chain in range(_chain_count(params)):
                    samples.append(convert_wilson_sample(_chain(params, chain), self.module))
            if samples:
                return samples

        # legacy layout: <root>/chain<k>/*.pkl of unstacked trees
        if os.path.isdir(root):
            for chain in sorted(os.listdir(root)):
                cdir = os.path.join(root, chain)
                if not os.path.isdir(cdir) or chain == dataset:
                    continue
                files = sorted(os.listdir(cdir))
                if max_per_chain:
                    files = files[:max_per_chain]
                for f in files:
                    ckpt = _load_pickle(os.path.join(cdir, f))
                    params = ckpt.get("params", ckpt) if isinstance(ckpt, dict) else ckpt
                    samples.append(convert_wilson_sample(params, self.module))
        if not samples:
            # hermetic fallback: a few perturbed draws around the init
            generator = torch.Generator().manual_seed(seed + 1)
            template = {k: v.detach() for k, v in self.module.state_dict().items()}
            for _ in range(4):
                samples.append({k: v + 0.05 * torch.randn(v.shape, generator=generator) for k, v in template.items()})
        return samples

    def _images(self, x) -> torch.Tensor:
        """NHWC numpy (the JAX layout) or an NCHW tensor -> NCHW on the
        device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2).to(self.device)

    def infer(self, x, n_samples: Optional[int] = None) -> torch.Tensor:
        """Log-prob predictions ``[S, B, 10]`` of the first ``n_samples``
        HMC draws (all without it; reference wilson.py:34-45)."""
        x = self._images(x)
        s = self.n_samples if n_samples is None else min(n_samples, self.n_samples)
        out = []
        with torch.no_grad():
            for i in range(s):
                params = {k: v[i] for k, v in self._stacked.items()}
                logits = torch.func.functional_call(self.module, params, (x,))
                out.append(F.log_softmax(logits, dim=-1))
        return torch.stack(out)

    def log_marginal(self, x, n_samples: Optional[int] = None) -> torch.Tensor:
        """The samples' log-mean-exp predictive ``[B, 10]``."""
        lp = self.infer(x, n_samples)
        return torch.logsumexp(lp, dim=0) - torch.log(torch.tensor(float(lp.shape[0]), device=lp.device))
