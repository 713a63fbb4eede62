from whvi_tpu.ops.hadamard import (
    build_H,
    fwht,
    fwht_butterfly,
    fwht_kron,
    is_pow_of_2,
    kl_diag_normal,
    kl_normal,
    get_fwht_precision,
    matmul_diag_left,
    matmul_diag_right,
    next_pow_of_2,
    set_fwht_precision,
)
from whvi_tpu.ops.whvi_op import (
    whvi_dense,
    whvi_mul,
    whvi_mul_dense_oracle,
)

__all__ = [
    "build_H",
    "fwht",
    "fwht_butterfly",
    "fwht_kron",
    "is_pow_of_2",
    "kl_diag_normal",
    "kl_normal",
    "get_fwht_precision",
    "matmul_diag_left",
    "matmul_diag_right",
    "next_pow_of_2",
    "set_fwht_precision",
    "whvi_dense",
    "whvi_mul",
    "whvi_mul_dense_oracle",
]
