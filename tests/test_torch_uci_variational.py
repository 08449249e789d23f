"""PyTorch port, UCI regression's models with variational layers: ``build``
-> ``train`` (4 steps at batch 16) -> ``evaluate`` (24 test points, S = 4)
of ``bbb``, ``bbb_fixed_kl`` and ``rank1`` of ``configs/uci.yaml``
held against the JAX package's engine on the CPU from the JAX package's
initial state, JAX's draws given (``_torch_uci_parity.run_both``: BBB's and
Rank-1's noise, the quantile calibration's normals);
then a BBB state carried across mid-run (``models/jax_convert.py::
state_from_jax``: Adam's moments and count inside the ``multi_transform``
state, the ``__mle`` parameter's SGD) and stepped on both sides.

Tolerances: the trained parameters and the five result metrics within 1e-5
relative and 1e-5 absolute (as ``test_torch_uci.py``); the mid-run state's
buffers within 1e-5 relative and 1e-6 absolute after two more steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, record_jax_normals
from _torch_uci_parity import N_TRAIN, check_matches_jax, config_for
from beyond_deep_ensembles_tpu.experiments import uci as jax_uci
from beyond_deep_ensembles_tpu.nn import gaussian as jax_gaussian
from beyond_deep_ensembles_tpu_torch.experiments import uci
from beyond_deep_ensembles_tpu_torch.models.jax_convert import state_from_jax
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

@pytest.mark.parametrize("model", ["bbb", "bbb_fixed_kl", "rank1"])
def test_build_train_evaluate_matches_jax(model, monkeypatch):
    check_matches_jax(model, monkeypatch)


def test_mid_run_state_steps_match_jax(monkeypatch):
    """A JAX BBB state after two jitted steps (Adam moments and count after
    coupled weight decay, the SGD'd ``rho__mle``) carried across mid-run:
    two more steps on each side, the port given JAX's draws, then the same
    state."""
    config = config_for("bbb", weight_decay=1e-4)
    draws = record_jax_normals(monkeypatch, jax_gaussian)
    jbuilt = jax_uci.build(config, N_TRAIN, jax.random.key(0))
    update = jax.jit(jbuilt.method.update)
    draws.clear()  # the initializers' draws
    rng = np.random.RandomState(3)
    batches = [(rng.standard_normal((16, 6)).astype(np.float32), rng.standard_normal((16, 1)).astype(np.float32))
               for _ in range(4)]
    state = jbuilt.state
    for i in range(4):
        state, _ = update(state, jax.random.key(i), tuple(map(jnp.asarray, batches[i])))
        if i == 1:
            mid = state
    jax.effects_barrier()
    assert int(mid.step) == 2 and len(draws) == 4 * 4  # mc 2 x 2 layers a step

    built = uci.build(config, N_TRAIN, torch.Generator().manual_seed(0), device="cpu")
    converted = state_from_jax(built.state.params, mid, lr=config["lr"], var_lr=config["var_lr"])
    assert int(converted["opt.main.count"]) == 2 and int(converted["opt.mle.count"]) == 2
    built.state.load_state_dict(converted)
    noise = NoiseSource(given=[torch.from_numpy(d) for d in draws[8:]])
    for i in (2, 3):
        built.state, _ = built.method.update(built.state, noise, tuple(map(torch.from_numpy, batches[i])))
    ref = state_from_jax(built.state.params, state, lr=config["lr"], var_lr=config["var_lr"])
    mine = built.state.state_dict()
    for k in ("opt.main.flat", "opt.main.mu", "opt.main.nu", "opt.mle.flat"):
        assert_close(mine[k].numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(mine["opt.main.count"]) == 4 and int(mine["opt.mle.count"]) == 4
