"""PyTorch port at a bf16 compute dtype on ResNet-50 (RxRx1): every row of
``configs/rxrx1.yaml`` with the key added builds at the tiny width and
takes one finite update, or raises where it raises at fp32 (none does);
the MAP row through ``run.main --device cpu`` (tests/_torch_bf16_cli.py)."""
import pytest

from _torch_bf16_cli import main_runs, one_update, rows

NAMES = list(rows("rxrx1")[1])


@pytest.mark.parametrize("name", NAMES)
def test_rxrx1_row_takes_a_bf16_update(name):
    one_update("rxrx1", "rxrx1", name)


def test_rxrx1_bf16_row_through_run_main(tmp_path):
    main_runs("rxrx1", "rxrx1", "MAP", tmp_path)
