"""PyTorch port, the last helpers and the last options, held against the JAX
package on the CPU: ``models/torch_convert.py::transplant_sngp_buffers``,
``tree.py::tree_cast``, ``evals/classification.py::binary_to_multiclass``,
``methods/last_layer.py::split_params`` / ``merge_params``, the ``hard``
synthetic CIFAR arrays, ``ops/attention.py::fused_attention_available``,
``methods/svgd.py::SvgdState``, ResNet-50's ``remat`` (``block``,
``stage``) and ``norm="none"``, the WILDS engine's ``conv_remat`` and
``no_norm`` rows, ``svgd`` with ``members: 2`` on CIFAR (JAX ignores
``members`` there; the port refused it before), and a name-level check that
every public class and function of the JAX package has a port counterpart.

Tolerances: equality for the helpers, the arrays, the remat forms against
``none`` and the svgd repair; ResNet-50 ``norm="none"`` logits within 1e-4
(as tests/test_torch_resnet50.py holds ResNet-50's)."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, load_jax_params, nchw, random_jax_params
from beyond_deep_ensembles_tpu.data import cifar as jax_cifar_data
from beyond_deep_ensembles_tpu.evals.classification import binary_to_multiclass as jax_binary_to_multiclass
from beyond_deep_ensembles_tpu.methods import last_layer as jax_last_layer
from beyond_deep_ensembles_tpu.models.resnet import ResNet50 as JaxResNet50
from beyond_deep_ensembles_tpu.models.torch_convert import transplant_sngp_buffers as jax_transplant
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu.nn.sngp import SNGPHead as JaxSNGPHead
from beyond_deep_ensembles_tpu_torch.data import cifar as cifar_data
from beyond_deep_ensembles_tpu_torch.evals.classification import binary_to_multiclass
from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task
from beyond_deep_ensembles_tpu_torch.methods.api import MethodState
from beyond_deep_ensembles_tpu_torch.methods.last_layer import merge_params, split_params
from beyond_deep_ensembles_tpu_torch.methods.svgd import SvgdState
from beyond_deep_ensembles_tpu_torch.models.jax_convert import buffers_from_jax
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet50
from beyond_deep_ensembles_tpu_torch.models.torch_convert import transplant_sngp_buffers
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.nn.sngp import SNGPHead
from beyond_deep_ensembles_tpu_torch.ops.attention import fused_attention_available
from beyond_deep_ensembles_tpu_torch.tree import tree_cast

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEN = torch.Generator().manual_seed(0)


def test_transplant_sngp_buffers_matches_jax():
    """A reference ``SNGPWrapper`` state_dict's ``rff.W``, ``rff.b`` and
    ``random_matrix`` ([G, D]) into the SNGP head's buffers, as JAX fills
    its ``buffers`` collection; a non-SNGP module passes unchanged."""
    rs = np.random.RandomState(0)
    ref = {"model.rff.W": torch.from_numpy(rs.standard_normal((4, 8)).astype(np.float32)),
           "model.rff.b": torch.from_numpy(rs.uniform(0, 6, 8).astype(np.float32)),
           "model.random_matrix": torch.from_numpy(rs.standard_normal((4, 6)).astype(np.float32)),
           "model.beta.weight": torch.zeros(3, 8)}
    jhead = JaxSNGPHead(outputs=3, num_random_features=8, num_gp_features=4)
    variables = jhead.init({"params": jax.random.key(0)}, jnp.zeros((2, 6)), train=True)
    state = {k: v for k, v in variables.items() if k != "params"}
    want = buffers_from_jax(jax.tree.map(np.asarray, {"buffers": jax_transplant(ref, state)["buffers"]}))
    head = SNGPHead(6, 3, num_random_features=8, num_gp_features=4, generator=GEN)
    assert transplant_sngp_buffers(ref, head) is head
    got = dict(head.named_buffers())
    assert set(want) == {"RandomFourierFeatures_0.W", "RandomFourierFeatures_0.b", "random_matrix"}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    plain = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in plain.state_dict().items()}
    transplant_sngp_buffers(ref, plain)
    assert all(torch.equal(before[k], v) for k, v in plain.state_dict().items())


def test_tree_cast():
    tree = {"a": torch.ones(3), "b.c": torch.arange(4, dtype=torch.float32)}
    cast = tree_cast(tree, torch.bfloat16)
    assert {k: v.dtype for k, v in cast.items()} == {"a": torch.bfloat16, "b.c": torch.bfloat16}
    assert torch.equal(cast["b.c"].float(), tree["b.c"])
    assert tree_cast(torch.ones(2), torch.float64).dtype == torch.float64


def test_binary_to_multiclass_matches_jax():
    p = np.random.RandomState(1).uniform(size=(3, 5, 1)).astype(np.float32)
    want = np.asarray(jax_binary_to_multiclass(jnp.asarray(p)))
    got = binary_to_multiclass(torch.from_numpy(p))
    assert got.shape == (3, 5, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_and_merge_params_match_jax():
    """The split's placeholders are JAX's (zero-size), and merge inverts it."""
    rs = np.random.RandomState(2)
    named = {"body.kernel": rs.standard_normal((3, 2)).astype(np.float32),
             "head.kernel": rs.standard_normal((2, 2)).astype(np.float32),
             "head.bias": rs.standard_normal(2).astype(np.float32)}
    mask = {k: k.startswith("head") for k in named}
    jb, jh = jax_last_layer.split_params({k: jnp.asarray(v) for k, v in named.items()}, mask)
    backbone, head = split_params({k: torch.from_numpy(v) for k, v in named.items()}, mask)
    for mine, theirs in ((backbone, jb), (head, jh)):
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert tuple(mine[k].shape) == theirs[k].shape
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]))
    merged = merge_params(backbone, head)
    assert all(torch.equal(merged[k], torch.from_numpy(v)) for k, v in named.items())
    module = torch.nn.Linear(3, 2)
    b, h = split_params(module, {"weight": False, "bias": True})
    assert h["weight"].numel() == 0 and torch.equal(h["bias"], module.bias)


@pytest.mark.parametrize("via", ["argument", "environment"])
def test_hard_synthetic_cifar_matches_jax(via, monkeypatch):
    """The ``hard`` variant's images and labels equal JAX's, bit for bit,
    whether asked for by argument or by ``BDE_SYNTH_HARD=1``; the default
    stays the easy arrays."""
    if via == "argument":
        got = cifar_data._synthetic_cifar(600, 3, hard=True)
    else:
        monkeypatch.setenv("BDE_SYNTH_HARD", "1")
        got = cifar_data._synthetic_cifar(600, 3)
    want = jax_cifar_data._synthetic_cifar(600, 3, hard=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    easy = jax_cifar_data._synthetic_cifar(600, 3, hard=False)
    assert not np.array_equal(got[0], easy[0])


def test_fused_attention_available_off_the_card():
    assert not fused_attention_available(512, "cpu")
    assert fused_attention_available(512, "cuda") == torch.cuda.is_available()
    assert not fused_attention_available(0, "cuda")


def test_svgd_state_is_the_method_state():
    assert SvgdState is MethodState


def _resnet50_pair(remat, dropout_p=None, norm="batch_static"):
    return ResNet50(5, activation="swish", norm=norm, dropout_p=dropout_p, stage_sizes=(2, 1), remat=remat,
                    dropout_freeze_eval=False, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("remat", ["block", "stage"])
def test_resnet50_remat_equals_none(remat):
    """Outputs and parameter gradients of a training step with dropout in
    every conv equal the plain forward's bit for bit: the recompute replays
    the forward's masks (key mode), and eval ignores ``remat``."""
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    runs = []
    for mode in ("none", remat):
        net = _resnet50_pair(mode, dropout_p=0.2)
        noise = NoiseSource(key=torch.tensor(7))
        out = net(x, noise, train=True)
        out.square().sum().backward()
        with torch.no_grad():
            ev = net(x, NoiseSource(key=torch.tensor(8)), train=False)
        runs.append((out.detach(), ev, {k: p.grad for k, p in net.named_parameters()}, noise.draws))
    (o0, e0, g0, d0), (o1, e1, g1, d1) = runs
    assert torch.equal(o0, o1) and torch.equal(e0, e1) and d0 == d1
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    with pytest.raises(ValueError):
        _resnet50_pair("layer")


def test_resnet50_without_norms_matches_jax():
    """``norm="none"`` (the JAX package's ``no_norm`` knob): no norm
    parameters, and JAX's logits."""
    jmod = JaxResNet50(classes=5, activation="swish", norm="none", stage_sizes=(1, 1))
    params = random_jax_params(jmod, (2, 32, 32, 3), seed=3)
    x = np.random.RandomState(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want, _, _ = jax.jit(lambda p, x: JaxModel(jmod).apply(p, {}, None, x, train=True))(params, jnp.asarray(x))
    net = ResNet50(5, activation="swish", norm="none", stage_sizes=(1, 1), generator=GEN)
    assert not any("Norm" in k for k in net.state_dict())
    load_jax_params(net, params)
    with torch.no_grad():
        got = net(nchw(x), None, train=True)
    assert_close(got.numpy(), np.asarray(want), rtol=0, atol=1e-4, err_msg="ResNet-50 norm none")


@pytest.mark.parametrize("task, extra", [
    ("iwildcam", {"conv_remat": "block"}),
    ("iwildcam", {"conv_remat": "stage", "no_norm": True}),
    ("camelyon17", {"no_norm": True}),
])
def test_wilds_rows_run_the_last_options(task, extra):
    """A tiny row through ``run_single`` on the CPU with the options the
    engine refused before: finite metrics."""
    config = {"model": "map", "tiny": True, "epochs": 1, "subsample": 8, "test_subsample": 4, "batch_size": 4,
              "eval_batch_size": 4, "eval_samples": 1, **extra}
    metrics = wilds_task.run_single(task, config, device="cpu")
    assert np.isfinite(metrics["accuracy"])


def test_cifar_svgd_ignores_members():
    """``svgd`` with ``members: 2`` builds, trains and evaluates as with one
    (JAX's CIFAR build returns from its svgd branch before the ensemble
    wrap), and JAX's build there holds one particle set."""
    from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar

    base = {**cifar.DEFAULT_CONFIG, "model": "svgd", "svgd_particles": 2, "epochs": 1, "subsample": 16,
            "test_subsample": 8, "batch_size": 8, "eval_batch_size": 8, "eval_samples": 2}
    results = []
    for members in (1, 2):
        results.append(cifar.run_single({**base, "members": members}, device="cpu"))
    one, two = results
    assert one.keys() == two.keys()
    for k, v in one.items():
        if isinstance(v, float):
            assert v == two[k], k
    jbuilt = jax_cifar.build({**jax_cifar.DEFAULT_CONFIG, **base, "members": 2, "dataset_size": 16},
                             jax.random.key(0), 2)
    assert jax.tree.leaves(jbuilt.state.params)[0].shape[0] == 2


# Public JAX names whose port counterpart has another name or place, each
# with what stands for it there.
COUNTERPARTS = {
    "data/native_loader.py": {
        "PrefetchLoader": "the engines gather each batch on the device or cut it from the host arrays "
                          "(experiments/wilds_task.py::_HostBatches) in shuffled_indices' order",
        "gather_rows": "numpy and torch indexing of the shuffled_indices rows",
    },
    "data/cifar.py": {"batch_iter": "experiments/cifar.py gathers each batch on the device"},
    "experiments/cifar.py": {"SNGPResNet20": "models/resnet.py::SNGPResNet20"},
    "methods/rings.py": {"place": "methods/rings.py::shard", "ring_spec": "methods/rings.py::RingSharding"},
    "models/layers.py": {"Conv": "nn/plain.py::Conv"},
    "nn/gaussian.py": {"eval_noise": "NoiseSource.normal", "gaussian_sample": "NoiseSource.parameter"},
    "ops/attention.py": {"reference_dropout_attention": "ops/attention.py::dropout_attention_plain"},
    "ops/sampling.py": {"fused_gaussian_sample": "ops/sampling.py::gaussian_sample"},
}
# the two JAX-only utilities, each with its note in the port's utils/__init__.py
NOT_PORTED = ("utils/perf.py", "utils/compile_cache.py")


def _public_defs(root: pathlib.Path, aliases: bool = False) -> dict:
    """{module path: its public top-level classes and functions}, and with
    ``aliases`` the names it binds by assignment (``SvgdState =
    MethodState``)."""
    out = {}
    for path in root.rglob("*.py"):
        names = set()
        for n in ast.parse(path.read_text()).body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(n.name)
            elif aliases and isinstance(n, ast.Assign):
                names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        out[str(path.relative_to(root))] = {name for name in names if not name.startswith("_")}
    return out


def test_every_public_jax_name_has_a_port_counterpart():
    """Every public top-level class and function of the JAX package is
    defined in the port module of the same path, or stands in
    :data:`COUNTERPARTS`; only the two utilities of :data:`NOT_PORTED` are
    left, and a grep of the port for "not ported" finds only their notes."""
    jax_defs = _public_defs(ROOT / "beyond_deep_ensembles_tpu")
    port_defs = _public_defs(ROOT / "beyond_deep_ensembles_tpu_torch", aliases=True)
    missing = {}
    for module, names in jax_defs.items():
        if module in NOT_PORTED:
            continue
        gone = sorted(n for n in names - port_defs.get(module, set()) if n not in COUNTERPARTS.get(module, {}))
        if gone:
            missing[module] = gone
    assert not missing, missing
    notes = [str(p.relative_to(ROOT)) for p in (ROOT / "beyond_deep_ensembles_tpu_torch").rglob("*.py")
             if "not ported" in p.read_text().lower()]
    assert sorted(notes) == ["beyond_deep_ensembles_tpu_torch/run.py",
                             "beyond_deep_ensembles_tpu_torch/utils/__init__.py"], notes
