"""PyTorch port at a bf16 compute dtype on ResNet-18 (PovertyMap): every row of
``configs/poverty.yaml`` with the key added builds at the tiny width and
takes one finite update, or raises where it raises at fp32 (none does);
the BBB row through ``run.main --device cpu`` (tests/_torch_bf16_cli.py)."""
import pytest

from _torch_bf16_cli import main_runs, one_update, rows

NAMES = list(rows("poverty")[1])


@pytest.mark.parametrize("name", NAMES)
def test_poverty_row_takes_a_bf16_update(name):
    one_update("poverty", "poverty", name)


def test_poverty_bf16_row_through_run_main(tmp_path):
    main_runs("poverty", "poverty", "BBB", tmp_path)
