"""PyTorch port, UCI regression as a whole: ``experiments/uci.py`` ``build``
-> ``train`` (4 steps at batch 16) -> ``evaluate`` (24 test points, S = 4)
of the models of ``configs/uci.yaml`` outside the BBB layers (``map``,
``laplace``, ``mcd``, ``swag``, ``svgd``, ``ivon``; ``learn_var`` on, as
the yaml has it) held against the JAX package's engine on the CPU, from the JAX
package's initial state carried across by ``models/jax_convert.py::
state_from_jax``, with JAX's draws given where a method samples
(``_torch_uci_parity.run_both``: MC-Dropout's masks, SWAG's and Laplace's
parameter draws, iVON's perturbations, the quantile calibration's
normals). The BBB and Rank-1 models are held the same way in ``test_torch_uci_variational.py``, so that
the JAX compiles spread over the suite's workers. Then the properties of
the port's own: ``run`` on the CPU with the gap splits, ``scan_steps``
through the multi-step runner, the refusals.

Tolerances: the trained parameters within 1e-5 relative and 1e-5 absolute
(four Adam steps at lr 0.01 and SGD steps on ``rho__mle``; the gradients'
sums are taken in other orders), the five result metrics within 1e-5
relative and 1e-5 absolute."""
import numpy as np
import pytest
import torch

from _torch_parity import one_cpu_thread  # noqa: F401 (a fixture)
from _torch_uci_parity import METRICS, YAML_DEFAULT, check_matches_jax, config_for
from beyond_deep_ensembles_tpu_torch.data.uci import UCIDataset
from beyond_deep_ensembles_tpu_torch.experiments import uci
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


@pytest.mark.parametrize("model", ["map", "laplace", "mcd", "swag", "svgd", "ivon"])
def test_build_train_evaluate_matches_jax(model, monkeypatch):
    check_matches_jax(model, monkeypatch)


def test_run_with_gap_split_on_cpu():
    """``run`` on the standard split and on every gap split of yacht (one
    repetition each, seeded by its dimension): finite metrics, QCE in
    [0, 1]."""
    res = uci.run({**YAML_DEFAULT, "model": "map", "epochs": 1, "eval_samples": 4, "gap": True}, device="cpu")
    assert len(res["plain"]) == 1 and [g["gap_split"] for g in res["gap_results"]] == list(range(6))
    for r in res["plain"] + [g["result"] for g in res["gap_results"]]:
        assert sorted(r) == sorted(METRICS) and all(np.isfinite(v) for v in r.values()) and 0.0 <= r["qce"] <= 1.0


@pytest.mark.parametrize("model", ["map", "bbb", "svgd"])
def test_scan_steps_runs_the_runner_steps(model):
    """``scan_steps`` 4 over 9 batches (two runner calls and one single
    update) equals the runner's steps made by hand: on the CPU the runner's
    steps run eagerly (``parallel/multistep.py::eager_steps``), keyed from
    the last step of each group; the leftover batch's step is counted twice,
    as the JAX loop counts it (``fold_in(seed, 10)`` for the ninth batch)."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.data.uci import batch_indices
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    ds = UCIDataset("yacht")
    x, y = ds.get_arrays("train")
    x, y = x[:144], y[:144]
    config = {**config_for(model, svgd_particles=3), "scan_steps": 4}
    a = uci.build(config, 144, torch.Generator().manual_seed(0), device="cpu")
    a = uci.train(a, config, x, y, seed=5)
    b = uci.build(config, 144, torch.Generator().manual_seed(0), device="cpu")
    rows = list(batch_indices(144, 16, np.random.RandomState(5)))
    batches = [(torch.from_numpy(x[r]), torch.from_numpy(y[r])) for r in rows]
    state = b.state
    state, _ = multistep.eager_steps(b.method.update, state, keys.fold_in(5, 4), batches[:4])
    state, _ = multistep.eager_steps(b.method.update, state, keys.fold_in(5, 8), batches[4:8])
    state, _ = b.method.update(state, NoiseSource(key=keys.as_key(keys.fold_in(5, 10), "cpu")), batches[8])
    for (name, p), q in zip(a.state.params.named_parameters(), state.params.parameters()):
        assert torch.equal(p, q), name


def test_refusals():
    config = config_for("svgd", members=2)
    with pytest.raises(NotImplementedError, match="particles"):
        uci.build(config, 32, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        uci.build(config_for("hmc"), 32, torch.Generator(), device="cpu")
    built = uci.build(config_for("map"), 32, torch.Generator(), device="cpu")
    x = np.zeros((32, 6), np.float32)
    with pytest.raises(NotImplementedError, match="item 18"):
        uci.train(built, {**config_for("map"), "data_parallel": True}, x, x[:, :1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            uci.build(config_for("map"), 32, torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            uci.run_single({"model": "map", "epochs": 1})
