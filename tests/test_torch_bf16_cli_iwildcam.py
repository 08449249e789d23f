"""PyTorch port at a bf16 compute dtype on ResNet-50 (iWildCam): every row of
``configs/iwildcam.yaml`` with the key added builds at the tiny width and
takes one finite update, or raises where it raises at fp32 (none does);
the MAP row through ``run.main --device cpu`` (tests/_torch_bf16_cli.py)."""
import pytest

from _torch_bf16_cli import main_runs, one_update, rows

NAMES = list(rows("iwildcam")[1])


@pytest.mark.parametrize("name", NAMES)
def test_iwildcam_row_takes_a_bf16_update(name):
    one_update("iwildcam", "iwildcam", name)


def test_iwildcam_bf16_row_through_run_main(tmp_path):
    main_runs("iwildcam", "iwildcam", "MAP", tmp_path)
