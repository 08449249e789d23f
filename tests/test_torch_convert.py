"""PyTorch port, models/torch_convert.py and the WILDS engine's pretrained
hook, against the JAX package's ``models/torch_convert.py``: a
torchvision-layout ResNet-50 state dict, written by the test (random values
under torchvision's key names and shapes, running statistics included; no
torchvision here), goes through JAX's ``convert_torch_state_dict`` onto
``ResNet50(torchvision=True)``'s flax parameters and through the port's onto
its ``ResNet50(torchvision=True)``:

  * at full width (stage sizes (3, 4, 6, 3), 182 classes): the port fills
    exactly the parameters JAX's order-based matching fills, each with the
    same tensor (the 1000-class ``fc`` unused, the running statistics
    dropped, the head left at its init), bit for bit;
  * at the tiny cut (stage sizes (1, 1)): the same, and the converted nets'
    logits within 1e-4 (fp32 through 9 convolutions and 9 batch norms);
  * ``build`` of iwildcam and rxrx1 with the file staged at
    ``$BDE_DATA_DIR/pretrained/resnet50.pth``: ``torchvision_arch`` turns on
    by default, every member, particle and last-layer backbone starts from
    the file (the port's parameters equal JAX's built ones wherever the file
    fills them), and ``pretrained: false`` builds the random net;
  * a staged ``densenet121.pth`` that does not load and a ResNet-50 file
    that does not fit raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, nchw
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.models.resnet import ResNet50 as JaxResNet50
from beyond_deep_ensembles_tpu.models.torch_convert import convert_torch_state_dict as jax_convert
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.methods.last_layer import LastLayerState
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet50
from beyond_deep_ensembles_tpu_torch.models.torch_convert import convert_torch_state_dict, load_torch_backbone


def torchvision_state_dict(stage_sizes, seed=0, classes=1000):
    """A state dict under torchvision ``resnet50``'s keys, in its order, cut
    to ``stage_sizes``: convs ``[O, I, kh, kw]`` without bias, batch norms'
    weight, bias and running statistics, the ``downsample`` projection of
    each stage's first block, an ``fc`` of ``classes``."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = 0.1 * torch.randn(cout, cin, k, k, generator=gen)

    def bn(key, c):
        sd[key + ".weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        sd[key + ".bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[key + ".running_mean"] = torch.randn(c, generator=gen)
        sd[key + ".running_var"] = torch.rand(c, generator=gen) + 0.5
        sd[key + ".num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage, blocks in enumerate(stage_sizes):
        width = 64 * 2**stage
        for block in range(blocks):
            key = f"layer{stage + 1}.{block}"
            conv(key + ".conv1", width, cin, 1)
            bn(key + ".bn1", width)
            conv(key + ".conv2", width, width, 3)
            bn(key + ".bn2", width)
            conv(key + ".conv3", 4 * width, width, 1)
            bn(key + ".bn3", 4 * width)
            if block == 0:
                conv(key + ".downsample.0", 4 * width, cin, 1)
                bn(key + ".downsample.1", 4 * width)
            cin = 4 * width
    sd["fc.weight"] = 0.1 * torch.randn(classes, cin, generator=gen)
    sd["fc.bias"] = 0.1 * torch.randn(classes, generator=gen)
    return sd


def _jax_filled(sd, stage_sizes, classes, init):
    """JAX's conversion: {port name: array} of the leaves it filled, and its
    whole converted tree."""
    module = JaxResNet50(classes=classes, torchvision=True, stage_sizes=stage_sizes)
    variables = init(module)
    params = variables["params"]
    converted = jax_convert(sd, params)
    changed = jax.tree.map(lambda a, b: not (isinstance(a, jax.ShapeDtypeStruct) or a is b), converted, params)
    flat = params_from_jax(jax.tree.map(lambda a, c: np.asarray(a) if c else np.zeros((0,)), converted, changed))
    return {k: v for k, v in flat.items() if v.numel()}, converted, module


def _holds_jax_matching(sd, stage_sizes, classes, init):
    want, converted, module = _jax_filled(sd, stage_sizes, classes, init)
    net = ResNet50(classes, torchvision=True, stage_sizes=stage_sizes, generator=torch.Generator())
    got = convert_torch_state_dict(sd, net)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not any(k.startswith("Dense_0") for k in got)
    return net, converted, module


def _ordered_shapes(module):
    """``module``'s variables as shapes, in the order its ``init`` creates
    them (the order JAX's converter walks, which ``jax.eval_shape``'s
    output, sorted by key, loses; an eager init at full width takes 25 s)."""
    order = []

    def init():
        variables = module.init({"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), train=True)

        def walk(node, prefix):
            for key, value in node.items():
                walk(value, prefix + (key,)) if hasattr(value, "items") else order.append(prefix + (key,))

        walk(variables["params"], ())
        return variables

    shapes = jax.eval_shape(init)["params"]
    out = {}
    for path in order:
        node, leaf = out, shapes
        for key in path[:-1]:
            node, leaf = node.setdefault(key, {}), leaf[key]
        node[path[-1]] = leaf[path[-1]]
    return {"params": out}


def test_full_width_conversion_matches_jax():
    sd = torchvision_state_dict((3, 4, 6, 3))
    net, _, _ = _holds_jax_matching(sd, (3, 4, 6, 3), 182, _ordered_shapes)
    # every conv and norm of the net filled: 53 convs, 53 norms x 2, no head
    assert len(convert_torch_state_dict(sd, net)) == 53 + 2 * 53


def test_tiny_conversion_and_logits_match_jax():
    sd = torchvision_state_dict((1, 1), seed=1)
    net, converted, module = _holds_jax_matching(sd, (1, 1), 5, _ordered_shapes)
    rng = np.random.RandomState(3)
    converted = jax.tree.map(  # the head, which the file does not fill, drawn here
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if isinstance(a, jax.ShapeDtypeStruct)
        else np.asarray(a), converted)
    net.load_state_dict(params_from_jax(converted), strict=True)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, xx: module.apply({"params": p}, xx, train=True))(converted, jnp.asarray(x)))
    got = net(nchw(x), None, train=True).detach().numpy()
    assert_close(got, want, rtol=0, atol=1e-4, err_msg="converted logits")


def _port_trees(built):
    """{port name: tensor} of every backbone the built state holds."""
    state = built.state
    if isinstance(state, LastLayerState):
        return [dict(state.backbone)]
    members = getattr(state, "members", [state])
    out = []
    for member in members:
        params = member.params
        for module in (params if isinstance(params, torch.nn.ModuleList) else [params]):
            out.append(dict(module.named_parameters()))
    return out


@pytest.mark.parametrize("task,model,extra", [("iwildcam", "map", {}), ("iwildcam", "ll_svgd", {"svgd_particles": 2}),
                                              ("rxrx1", "map", {"members": 2}),
                                              ("rxrx1", "svgd", {"svgd_particles": 2})])
def test_build_loads_staged_resnet50(task, model, extra, tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    (tmp_path / "pretrained").mkdir()
    sd = torchvision_state_dict((1, 1), seed=2)
    torch.save(sd, tmp_path / "pretrained" / "resnet50.pth")
    config = {**wilds_task.DEFAULT_CONFIG, "tiny": True, "model": model, "dataset_size": 8, "steps_per_epoch": 2,
              "optimizer_kind": "adam", **extra}
    jbuilt = jax_wilds.build(task, config, jax.random.key(0), 2)
    jparams = jbuilt.state.params if model != "ll_svgd" else jbuilt.state.backbone
    jflat = jax.tree.map(np.asarray, jparams)
    if model in ("svgd",) or extra.get("members", 1) > 1:
        jflat = jax.tree.map(lambda a: a[0], jflat)
    jflat = params_from_jax({k: v for k, v in jflat.items()})
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), 2, device="cpu")
    net = ResNet50(5, torchvision=True, stage_sizes=(1, 1), generator=torch.Generator())
    filled = convert_torch_state_dict(sd, net)
    trees = _port_trees(built)
    assert len(trees) == {"svgd": 2, "ll_svgd": 1}.get(model, extra.get("members", 1))
    for tree in trees:
        assert "_Norm_0.StaticBatchNorm_0.scale" in tree  # the torchvision topology
        for name, value in filled.items():
            assert torch.equal(tree[name].detach(), value), name
            if jflat[name].numel():
                assert torch.equal(tree[name].detach(), jflat[name]), name
    random = wilds_task.build(task, {**config, "pretrained": False}, torch.Generator().manual_seed(0), 2, device="cpu")
    assert "_Norm_0.StaticBatchNorm_0.scale" not in _port_trees(random)[0]


def test_unported_or_unfit_weights_raise(tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    (tmp_path / "pretrained").mkdir()
    (tmp_path / "pretrained" / "densenet121.pth").write_bytes(b"")
    config = {**wilds_task.DEFAULT_CONFIG, "tiny": True, "model": "map", "dataset_size": 8}
    with pytest.raises(EOFError):  # loaded since fmow's weights are ported: this one does not load
        wilds_task.build("fmow", config, torch.Generator(), device="cpu")
    torch.save({"fc.weight": torch.zeros(3, 4), "conv.weight": torch.zeros(2, 2, 1, 1), "x.bias": torch.zeros(9)},
               tmp_path / "pretrained" / "resnet50.pth")
    with pytest.raises(ValueError):
        load_torch_backbone(str(tmp_path / "pretrained" / "resnet50.pth"),
                            ResNet50(5, stage_sizes=(1, 1), generator=torch.Generator()))
