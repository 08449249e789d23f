"""PyTorch port at a bf16 compute dtype on the CIFAR ResNet-20: every row
of ``configs/cifar.yaml`` with ``bf16: true`` builds and takes one finite
update (members cut to 2), or raises where it raises at fp32 (none does);
the BBB row through ``run.main --device cpu`` (tests/_torch_bf16_cli.py)."""
import pytest

from _torch_bf16_cli import main_runs, one_cifar_update, rows

NAMES = list(rows("cifar")[1])


@pytest.mark.parametrize("name", NAMES)
def test_cifar_row_takes_a_bf16_update(name):
    one_cifar_update(name)


def test_cifar_bf16_row_through_run_main(tmp_path):
    main_runs("cifar", "cifar", "BBB", tmp_path)
