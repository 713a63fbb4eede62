from whvi_tpu.utils.compile_cache import enable_compile_cache
from whvi_tpu.utils.metrics import JsonlLogger, Throughput
from whvi_tpu.utils.profiling import (
    DEVICE_PEAKS,
    chain_time,
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

__all__ = [
    "DEVICE_PEAKS",
    "JsonlLogger",
    "Throughput",
    "chain_time",
    "elbo_step_flops",
    "enable_compile_cache",
    "fwht_flops",
    "hbm_bytes_per_s",
    "mfu",
    "net_train_step_flops",
    "peak_flops",
    "whvi_layer_fwd_flops",
    "whvi_layer_train_flops",
    "whvi_mul_flops",
]
