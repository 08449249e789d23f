"""PyTorch port, models/tiramisu.py (``MidasTiramisu``, ``DenseNetBlock``,
``ResidualConvUnit``, ``FeatureFusionBlock``, ``_upsample2x``), held
against the JAX package's model on its own init, converted, on the CPU.

Tolerances: the depth map within 1e-5 of its largest value
(``features=16`` at 32x32: 45 convolutions and four 2x bilinear
upsamplings); the upsampling alone within 1e-6 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_close, load_jax_params, nchw
from beyond_deep_ensembles_tpu.models.tiramisu import MidasTiramisu as JaxTiramisu
from beyond_deep_ensembles_tpu_torch.models import MidasTiramisu
from beyond_deep_ensembles_tpu_torch.models.tiramisu import DenseNetBlock, FeatureFusionBlock, ResidualConvUnit

GEN = torch.Generator().manual_seed(0)


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def test_tiramisu_matches_jax():
    jmod = JaxTiramisu(features=16)
    x = _x((2, 32, 32, 3), 11)
    params = jax.jit(lambda k: jmod.init(k, jnp.zeros((1, 32, 32, 3))))(jax.random.key(0))["params"]
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, jnp.asarray(x))
    net = load_jax_params(MidasTiramisu(features=16, generator=GEN), params)
    assert isinstance(net.DenseNetBlock_3, DenseNetBlock)
    assert isinstance(net.FeatureFusionBlock_0.ResidualConvUnit_1, ResidualConvUnit)
    assert isinstance(net.FeatureFusionBlock_2, FeatureFusionBlock)
    with torch.no_grad():
        got = net(nchw(x))
    want = np.asarray(want)
    assert got.shape == (2, 1, 32, 32) and want.shape == (2, 32, 32, 1)
    assert np.abs(want).max() > 0
    assert_close(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                 err_msg="MidasTiramisu depth")


def test_upsample_matches_jax_resize():
    """The 2x bilinear upsampling alone, edges included, on an odd-sized
    plane (torch's edge clamp against ``jax.image.resize``'s renormalised
    triangle kernel)."""
    from beyond_deep_ensembles_tpu.models.tiramisu import _upsample2x as jax_up
    from beyond_deep_ensembles_tpu_torch.models.tiramisu import _upsample2x

    x = _x((2, 5, 7, 3), 12)
    want = np.asarray(jax_up(jnp.asarray(x)))
    got = _upsample2x(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert_close(got, want, rtol=0, atol=1e-6, err_msg="upsample2x")
