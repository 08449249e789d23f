"""PyTorch port at a bf16 compute dtype on DistilBERT (Amazon): every row of
``configs/amazon.yaml`` with the key added builds at the tiny width and
takes one finite update, or raises where it raises at fp32 (none does);
the MCD row through ``run.main --device cpu`` (tests/_torch_bf16_cli.py)."""
import pytest

from _torch_bf16_cli import main_runs, one_update, rows

NAMES = list(rows("amazon")[1])


@pytest.mark.parametrize("name", NAMES)
def test_amazon_row_takes_a_bf16_update(name):
    one_update("amazon", "amazon", name)


def test_amazon_bf16_row_through_run_main(tmp_path):
    main_runs("amazon", "amazon", "MCD", tmp_path)
