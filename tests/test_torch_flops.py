"""The port's peak table (``distributed_tensorflow_tpu_torch/utils/flops.py``):
each card is keyed by its full device name and matched exactly, so a
card whose published rate differs from the SXM H100's raises instead of
getting that card's peak."""

import pytest

from distributed_tensorflow_tpu_torch.obs import goodput
from distributed_tensorflow_tpu_torch.utils import flops


def test_the_sxm_h100_gets_its_published_dense_bf16_rate():
    assert flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops_per_chip("cpu") == 1e12


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA H100",
                                  "NVIDIA H100 80GB HBM3 MIG 1g.10gb", "nvidia h100 80gb hbm3",
                                  "NVIDIA A100-SXM4-80GB"])
def test_other_cards_raise_until_their_rate_is_added(kind):
    with pytest.raises(KeyError, match="no peak FLOP/s"):
        flops.peak_flops_per_chip(kind)


def test_mfu_reads_the_peak_of_the_named_card():
    sxm = flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3")
    assert flops.mfu(989e12, 0.5, 1, sxm) == pytest.approx(0.5)
    assert goodput.train_mfu(1e12, 2.0, peak_per_chip=sxm) == pytest.approx(6e12 / 989e12)
