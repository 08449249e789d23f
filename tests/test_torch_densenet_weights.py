"""PyTorch port, fmow's staged ``densenet121.pth`` through
models/torch_convert.py (``load_torch_backbone``) and the WILDS engine's
pretrained hook, against the JAX package's converter: a torchvision-layout
DenseNet state dict, written by the test (random values under torchvision
``densenet121``'s key names and shapes, running statistics included; no
torchvision here):

  * at DenseNet-121's full width (growth 32, blocks (6, 12, 24, 16)): the
    port's order-based matching fills exactly the parameters JAX's fills on
    its DenseNet classifier's parameters in creation order, each with the
    same tensor (the 1000-class classifier unused, the running statistics
    dropped, the 62-class head left at its init), bit for bit;
  * ``build`` of fmow (MAP, SVGD's particles, a MAP ensemble) at the engine's
    tiny DenseNet with a file of its shape staged at
    ``$BDE_DATA_DIR/pretrained/densenet121.pth``: every backbone equals the
    file and JAX's built one where the file fills it; ``pretrained: false``
    builds the random net; camelyon17 trains from scratch whatever is
    staged."""
import jax
import numpy as np
import pytest
import torch

from test_torch_convert import _ordered_shapes
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.models.torch_convert import convert_torch_state_dict as jax_convert
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.models.torch_convert import convert_torch_state_dict

FULL = dict(growth=32, blocks=(6, 12, 24, 16), init=64, bn_size=4)
TINY = dict(growth=4, blocks=(2, 2), init=8, bn_size=2)


def torchvision_densenet_state_dict(growth, blocks, init, bn_size, classes=1000, seed=0):
    """A state dict under torchvision ``densenet121``'s keys, in its order
    (``features.conv0``, ``norm0``, ``denseblock<b>.denselayer<l>``'s
    ``norm1``/``conv1``/``norm2``/``conv2``, ``transition<t>``'s
    ``norm``/``conv``, ``norm5``, ``classifier``), convs without bias."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = 0.1 * torch.randn(cout, cin, k, k, generator=gen)

    def bn(key, c):
        sd[key + ".weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        sd[key + ".bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[key + ".running_mean"] = torch.randn(c, generator=gen)
        sd[key + ".running_var"] = torch.rand(c, generator=gen) + 0.5
        sd[key + ".num_batches_tracked"] = torch.tensor(3)

    conv("features.conv0", init, 3, 7)
    bn("features.norm0", init)
    c = init
    for b, layers in enumerate(blocks):
        for i in range(layers):
            key = f"features.denseblock{b + 1}.denselayer{i + 1}"
            bn(key + ".norm1", c)
            conv(key + ".conv1", bn_size * growth, c, 1)
            bn(key + ".norm2", bn_size * growth)
            conv(key + ".conv2", growth, bn_size * growth, 3)
            c += growth
        if b < len(blocks) - 1:
            bn(f"features.transition{b + 1}.norm", c)
            conv(f"features.transition{b + 1}.conv", c // 2, c, 1)
            c //= 2
    bn("features.norm5", c)
    sd["classifier.weight"] = 0.1 * torch.randn(classes, c, generator=gen)
    sd["classifier.bias"] = 0.1 * torch.randn(classes, generator=gen)
    return sd


def _config(tiny, **extra):
    return {**jax_wilds.DEFAULT_CONFIG, "tiny": tiny, "model": "map", "dataset_size": 8, "steps_per_epoch": 2,
            "optimizer_kind": "adam", **extra}


def test_full_width_densenet121_conversion_matches_jax():
    sd = torchvision_densenet_state_dict(**FULL)
    config = _config(False)
    params = _ordered_shapes(jax_wilds._make_backbone("fmow", config, "plain").module)["params"]
    converted = jax_convert(sd, params)
    changed = jax.tree.map(lambda a, b: not (isinstance(a, jax.ShapeDtypeStruct) or a is b), converted, params)
    want = params_from_jax(jax.tree.map(lambda a, c: np.asarray(a) if c else np.zeros((0,)), converted, changed))
    want = {k: v for k, v in want.items() if v.numel()}
    net = wilds_task._make_backbone("fmow", config, torch.Generator())
    got = convert_torch_state_dict(sd, net)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # 120 convs and 121 norms (scale and bias) filled; the head and the conv biases keep their init
    assert len(got) == 120 + 2 * 121 and not any("Dense_0" in k for k in got)


def _backbones(built):
    state = built.state
    out = []
    for member in getattr(state, "members", [state]):
        params = member.params
        out += [dict(m.named_parameters()) for m in (params if isinstance(params, torch.nn.ModuleList) else [params])]
    return out


@pytest.mark.parametrize("model,extra", [("map", {}), ("svgd", {"svgd_particles": 2}), ("map", {"members": 2})])
def test_build_loads_staged_densenet121(model, extra, tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    (tmp_path / "pretrained").mkdir()
    sd = torchvision_densenet_state_dict(**TINY, seed=1)
    torch.save(sd, tmp_path / "pretrained" / "densenet121.pth")
    config = _config(True, model=model, **extra)
    jbuilt = jax_wilds.build("fmow", config, jax.random.key(0), 2)
    jflat = jax.tree.map(np.asarray, jbuilt.state.params)
    if model == "svgd" or extra.get("members", 1) > 1:
        jflat = jax.tree.map(lambda a: a[0], jflat)
    jflat = params_from_jax(jflat)
    built = wilds_task.build("fmow", config, torch.Generator().manual_seed(0), 2, device="cpu")
    filled = convert_torch_state_dict(sd, wilds_task._make_backbone("fmow", config, torch.Generator()))
    trees = _backbones(built)
    assert len(trees) == {"svgd": 2}.get(model, extra.get("members", 1)) and filled
    for tree in trees:
        for name, value in filled.items():
            assert torch.equal(tree[name].detach(), value), name
            assert torch.equal(tree[name].detach(), jflat[name]), name
    random = wilds_task.build("fmow", {**config, "pretrained": False}, torch.Generator().manual_seed(0), 2,
                              device="cpu")
    name = next(iter(filled))
    assert not torch.equal(_backbones(random)[0][name].detach(), filled[name])
    scratch = wilds_task.build("camelyon17", config, torch.Generator().manual_seed(0), 2, device="cpu")
    assert not torch.equal(_backbones(scratch)[0][name].detach(), filled[name])
