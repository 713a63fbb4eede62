"""Gradient-correctness CLI for every FWHT/WHVI backend.

Parity with reference src/fwht/grad_check.py:8-34 (which is bit-rotted:
it feeds 3-D input to 2-D-asserting transforms). Uses
``jax.test_util.check_grads`` in float64 on CPU for the jnp backends and
a self-adjointness check for the C++ oracle.

Run: python benchmarks/grad_check.py [--backend butterfly|kron|cpp]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from jax.test_util import check_grads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--backend",
        choices=["butterfly", "kron", "cpp", "all"],
        default="all",
    )
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()

    from whvi_tpu.ops import fwht_butterfly, fwht_kron

    x = jax.random.normal(
        jax.random.PRNGKey(0), (args.batch, args.dim), jnp.float64
    )
    backends = (
        ["butterfly", "kron", "cpp"]
        if args.backend == "all"
        else [args.backend]
    )
    for b in backends:
        if b == "butterfly":
            check_grads(fwht_butterfly, (x,), order=2, modes=["fwd", "rev"])
            print("butterfly: check_grads OK (float64, order 2)")
        elif b == "kron":
            check_grads(fwht_kron, (x,), order=2, modes=["fwd", "rev"])
            print("kron: check_grads OK (float64, order 2)")
        elif b == "cpp":
            from whvi_tpu.ops.cpu_oracle import fwht_cpp, oracle_available

            if not oracle_available():
                print("cpp: oracle unavailable (build failed)")
                continue
            # C++ oracle is not differentiable; check self-adjointness
            # numerically: <H x, y> == <x, H y>
            y = np.random.RandomState(0).randn(args.batch, args.dim)
            lhs = np.sum(fwht_cpp(np.asarray(x)) * y)
            rhs = np.sum(np.asarray(x) * fwht_cpp(y))
            np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
            print("cpp: self-adjointness OK (float64)")


if __name__ == "__main__":
    main()
