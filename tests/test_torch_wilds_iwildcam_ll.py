"""PyTorch port, experiments/wilds_task.py: the LL_SVGD (K2 on the head's
particles), LL_iVON, SNGP (a spectral ResNet-50 under the SNGP head) and
Laplace (``kron``) rows of ``configs/iwildcam.yaml`` held against the JAX
package's engine on the CPU (``_torch_wilds_parity.check_row``): ``build``
from JAX's initial state, three ``train`` updates and ``eval_task`` with
JAX's draws given, at the engine's tiny ResNet-50 (stage sizes (1, 1)) on
32x32 crops, both engines' ResNet-50 under swish (``swish_resnets``).

Tolerances: every state tensor within 2e-6 after the three updates (SVGD
2e-5; a bottleneck conv's bias, whose gradient is zero in exact arithmetic,
within 6 lr); SNGP by its precision before the epoch's reset, within 3e-3 of
its largest entry, and its Adam moments within 1e-4 of theirs, one element
in a hundred of a tensor free to lie beyond (``RESNET_SNGP_*``: the
spectral ResNet-50's RFF phases make its fp32 gradient ill-conditioned, on
both sides against float64), JAX's covariance then loaded for eval; the
Laplace fit by its Kronecker factors (A within 1e-4 of its largest entry,
``RESNET_FACTOR_TOL``), JAX's fit then evaluated; every float metric within
1e-5, relative or absolute."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

@pytest.mark.parametrize("name", ["LL_SVGD", "LL_iVON", "SNGP", "Laplace"])
def test_iwildcam_row_matches_jax(name, monkeypatch):
    check_row("iwildcam", yaml_row("iwildcam", name), monkeypatch)
