"""PyTorch port, experiments/wilds_task.py: the MAP row of
``configs/poverty.yaml`` (ResNet-18 on 8 channels under
GaussLayer, Adam at lr 1e-3 under the ``exponential`` schedule, the
regression eval and the worst urban/rural Pearson r) held against the JAX
package's engine on the CPU (``_torch_wilds_parity.check_row``): ``build``
from JAX's initial state, three ``train`` updates and ``eval_task`` with
JAX's draws given (the quantile calibration's normals among them), on
32x32 crops, both engines' ResNet-18 under swish (``swish_resnets``: ReLU's
kink makes fp32 gradients of two frameworks part). Laplace fits the
``full`` last-layer posterior on ResNet-18's one-output ``Dense_0`` with
the regression GGN (``I / sigma^2`` on GaussLayer's mean channel) on both
sides (tests/test_torch_wilds_poverty_laplace.py). The other rows are in
tests/test_torch_wilds_poverty_{mcd,laplace,swag,vi,svgd,rank1,ivon}.py,
one a file (JAX's trace and compile of a ResNet-18 update is most of a
row's time).

Tolerances (``_torch_wilds_parity``, REGRESSION_STATE_TOL): the fp32
update of every row is ill-conditioned here (GaussLayer's NLL at std 0.1,
Adam at lr 1e-3: both engines' parameters land about 1.8 % of the change
from a float64 update of the same start), so each engine's state after the
three updates is held against the port's float64 update: JAX's parameter
change within 3 x the port's own fp32 error, each whole state (``rho__mle``,
Adam's buffers, SWAG's moments and ring, iVON's) within 3e-3 (relative
L2), and each leaf of it (a parameter, or its segment of a flat state
vector) within 5 % of its change, 30 % where every element lies within 3
lr, a zero-gradient conv bias within 6 lr (REGRESSION_LEAF_TOL); each
update's metrics (loss, and data_loss and kl or backbone_loss where the
method reports them), the port's against JAX's, within 3e-5 relative for
the first update and 3e-3 for the later two; then the port takes JAX's
trained state, and the Laplace fit is held as
``_hold_full_laplace`` states and every metric within 1e-4, relative or
absolute (REGRESSION_METRIC_TOL)."""
import pytest

from _torch_wilds_parity import check_row, yaml_row


@pytest.mark.parametrize("name", ["MAP"])
def test_poverty_row_matches_jax(name, monkeypatch):
    check_row("poverty", yaml_row("poverty", name), monkeypatch)
