"""Analytic flop-counter units and the per-card peak table (the MFU
audit mechanism).

The counters feed the mfu columns of run_scaling / precision_check /
bench.py; the convention is matmul FLOPs only, with the merged-u LRT
counted as ONE fused product per layer per sample (it caught its own
first bug: a 2-product LRT count produced a >100%-MFU serving row). The
peak table is what those columns divide by.
"""

import jax
import pytest

from whvi_tpu.models import WHVILinear, WHVIRegression, relu
from whvi_tpu.utils import (
    DEVICE_PEAKS,
    elbo_step_flops,
    fwht_flops,
    hbm_bytes_per_s,
    mfu,
    net_train_step_flops,
    peak_flops,
    whvi_layer_fwd_flops,
    whvi_layer_train_flops,
    whvi_mul_flops,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_fwht_flops_formula():
    # D=256 factors as (128, 2): 2 * B * D * (128 + 2)
    assert fwht_flops(256, 32) == 2 * 32 * 256 * 130
    # D=16384 factors as (128, 128)
    assert fwht_flops(16384, 512) == 2 * 512 * 16384 * 256


def test_product_and_layer_counts():
    B, D = 64, 1024
    assert whvi_mul_flops(D, B) == 2 * fwht_flops(D, B)
    # merged-u LRT: forward is ONE product, lrt flag changes nothing
    assert whvi_layer_fwd_flops(D, B, lrt=True) == whvi_mul_flops(D, B)
    assert whvi_layer_fwd_flops(D, B, lrt=False) == whvi_mul_flops(D, B)
    # H constant => bwd == fwd, train = 2x
    assert whvi_layer_train_flops(D, B) == 2 * whvi_mul_flops(D, B)
    assert whvi_layer_train_flops(D, B, stack=4) == 8 * whvi_mul_flops(D, B)


def test_net_counter_matches_hand_count():
    net = WHVIRegression(
        [
            WHVILinear(3, 16),   # stacked: D_in=4, stack=4
            relu,
            WHVILinear(16, 16),  # square D=16
            relu,
            WHVILinear(16, 1),   # column: no matmul, excluded
        ],
        train_samples=2,
    )
    B = 64
    want = 2 * (
        whvi_layer_train_flops(4, B, stack=4)
        + whvi_layer_train_flops(16, B)
    )
    assert net_train_step_flops(net, B) == want
    assert elbo_step_flops([16], B, 2) == 2 * whvi_layer_train_flops(16, B)


def test_peak_table_h100_sxm_data_sheet():
    # NVIDIA H100 SXM data sheet, dense rates
    assert DEVICE_PEAKS[H100] == {
        "bf16": 989e12,
        "tf32": 495e12,
        "fp32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    }
    assert hbm_bytes_per_s(H100) == 3.35e12


@pytest.mark.parametrize(
    "mode,rate", [("bf16", 989e12), ("default", 495e12), ("highest", 67e12)]
)
def test_peak_flops_maps_precision_modes(mode, rate):
    # "bf16" -> bf16 tensor cores, "default" -> TF32, "highest" -> fp32
    assert peak_flops(H100, mode) == rate


def test_peak_flops_default_mode_is_tf32():
    assert peak_flops(H100) == DEVICE_PEAKS[H100]["tf32"]


def test_unknown_device_kind_is_an_error():
    with pytest.raises(KeyError, match="no peak rates"):
        peak_flops("NVIDIA GeForce RTX 2070 SUPER")
    with pytest.raises(KeyError, match="no peak rates"):
        hbm_bytes_per_s("NVIDIA A100-SXM4-40GB")


def test_unknown_precision_mode_is_an_error():
    with pytest.raises(ValueError, match="precision"):
        peak_flops(H100, "fp8")


def test_mfu_is_none_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    assert mfu(1e12) is None
    assert mfu(1e12, jax.devices()[0], "bf16") is None


def test_mfu_divides_by_the_cards_peak():
    class FakeCard:
        platform = "gpu"
        device_kind = H100

    assert mfu(49.5e12, FakeCard()) == pytest.approx(0.1)
    assert mfu(98.9e12, FakeCard(), "bf16") == pytest.approx(0.1)

    class UnknownCard(FakeCard):
        device_kind = "NVIDIA GeForce GTX 970"

    with pytest.raises(KeyError):
        mfu(1e12, UnknownCard())
