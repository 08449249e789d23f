"""PyTorch port, models/resnet.py's ``Bottleneck`` and ``ResNet50`` against
the JAX package's, at the WILDS engine's tiny cut (stage sizes (1, 1)) on
32x32 inputs, with JAX's weights (``models/jax_convert.py``) and JAX's draws
(``_torch_resnet50_parity.check_case``; its gradients under swish, as a
ReLU input at rounding distance of zero takes another side of the kink in
each framework): the plain kind (batch-static norms) and the torchvision
topology (their static-BN forward is the same at train and eval) and the
spectral featurizer (``features_only``, the SNGP trunk; its power iteration
advances in training only) here, the other kinds in
tests/test_torch_resnet50_kinds.py; and at full width (stage sizes (3, 4, 6,
3)) the port's parameter names and shapes against ``jax.eval_shape`` of
JAX's ``init``, for the plain and torchvision nets and the SNGP featurizer,
with iwildcam's 182 and rxrx1's 1139 classes.

Tolerances: logits 1e-4, parameter gradients 1e-4 of the largest gradient
(fp32 sums in another order on each side); the structure exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_resnet50_parity import check_case
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.models.resnet import ResNet50 as JaxResNet50
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20, ResNet50


@pytest.mark.parametrize("case,train", [("plain", True), ("torchvision", True), ("spectral-features", True),
                                        ("spectral-features", False)],
                         ids=["plain", "torchvision", "spectral-features-train", "spectral-features-eval"])
def test_resnet50_matches_jax(case, train, monkeypatch):
    check_case(case, train, monkeypatch)


def _jax_shapes(tree, prefix=()):
    """A flax shape tree as {port name: port shape} (conv kernels HWIO ->
    OIHW, dense kernels [in, out] -> [out, in])."""
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if hasattr(value, "items"):
            out.update(_jax_shapes(value, path))
        else:
            shape = tuple(value.shape)
            if key.startswith("kernel") and len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            elif key.startswith("kernel") and len(shape) == 2:
                shape = shape[::-1]
            out[".".join(path)] = shape
    return out


@pytest.mark.parametrize("classes", [182, 1139], ids=["iwildcam", "rxrx1"])
@pytest.mark.parametrize("kind", ["plain", "torchvision", "sngp"])
def test_full_width_structure_matches_jax(kind, classes):
    size = 64  # any input the stem, the pool and three stride-2 stages reduce
    if kind == "sngp":
        config = {**jax_wilds.DEFAULT_CONFIG, "tiny": False,
                  "sngp": {**jax_wilds.DEFAULT_CONFIG["sngp"], "num_random_features": 1024}}
        task = "iwildcam" if classes == 182 else "rxrx1"
        jmodule = jax_wilds._make_sngp(task, config).module
        net = wilds_task._make_sngp(task, config, torch.Generator())
    else:
        tv = kind == "torchvision"
        jmodule = JaxResNet50(classes=classes, torchvision=tv)
        net = ResNet50(classes, torchvision=tv, generator=torch.Generator())
    variables = jax.eval_shape(lambda: jmodule.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                                                    jnp.zeros((2, size, size, 3)), train=True))
    want = _jax_shapes(variables["params"])
    got = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert got == want
    for collection in ("spectral_norm", "sngp", "buffers"):
        for name, shape in _jax_shapes(variables.get(collection, {})).items():
            assert tuple(net.get_buffer(name).shape) == shape, name
    if kind != "sngp":
        assert sum(np.prod(s) for s in got.values()) == {"plain": 23_895_862, "torchvision": 23_880_950}[kind] + (
            (classes - 182) * 2049)


def test_not_ported_options_raise():
    gen = torch.Generator()
    with pytest.raises(NotImplementedError):
        ResNet50(5, stage_sizes=(1, 1), remat="block", generator=gen)
    with pytest.raises(NotImplementedError):
        ResNet50(5, stage_sizes=(1, 1), dtype=torch.bfloat16, generator=gen)
    with pytest.raises(NotImplementedError):
        ResNet20(10, "swish", "none", "plain", generator=gen)
    with pytest.raises(ValueError):
        ResNet50(5, stage_sizes=(1, 1), activation="gelu", generator=gen)
