"""Tests that need an NVIDIA GPU.

They carry the ``gpu`` marker and skip on any other backend; whether a
card is present is decided inside each test. ``python chip_smoke.py``
runs them on the card (in its own process, which holds the card).
"""

import jax
import numpy as np
import pytest

from whvi_tpu.ops import build_H, fwht


def _require_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on the card")


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.gpu
def test_peak_table_covers_this_card():
    from whvi_tpu.utils import hbm_bytes_per_s, mfu, peak_flops

    _require_gpu()
    dev = jax.devices()[0]
    assert peak_flops(dev.device_kind, "bf16") > peak_flops(
        dev.device_kind, "default"
    ) > peak_flops(dev.device_kind, "highest")
    assert hbm_bytes_per_s(dev.device_kind) > 0
    assert mfu(1e12, dev) == pytest.approx(
        1e12 / peak_flops(dev.device_kind, "default")
    )


@pytest.mark.gpu
def test_default_precision_rounds_operands_on_card():
    # On the card "default" runs fp32 operands in TF32: clearly less
    # exact than "highest" (true fp32), clearly more than bf16.
    _require_gpu()
    D = 1024
    x = np.random.RandomState(0).randn(64, D).astype(np.float32)
    ref = x.astype(np.float64) @ np.asarray(build_H(D), np.float64)
    err = {
        m: _rel(jax.jit(lambda v, m=m: fwht(v, precision=m))(x), ref)
        for m in ("highest", "default", "bf16")
    }
    assert err["highest"] < 1e-5, err
    assert 10 * err["highest"] < err["default"] < 5e-3, err
    assert err["default"] < err["bf16"] < 3e-2, err
