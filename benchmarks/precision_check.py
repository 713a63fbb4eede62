"""Numerics + speed of the three ``fwht_kron`` precision modes vs the f64
oracle.

What do the matrix units *actually* compute in each precision mode? For
each D it reports, per mode ("default" = backend default, TF32 operands
on an NVIDIA GPU; "highest" = Precision.HIGHEST true fp32; "bf16" =
bfloat16 operands):

- max relative error of ``whvi_mul`` vs the float64 C++ oracle
  (``ops/cpu_oracle.whvi_mul_cpp``) on random diagonals/activations;
- per-application time over a difference-timed on-device chain
  (norm-preserving random-sign diagonals: an identity-valued chain can
  be shortcut by the compiler and read above the roofline);
- effective memory GB/s and matmul TFLOP/s, and their share of the
  card's peaks (``utils.profiling.DEVICE_PEAKS``; null on the CPU).

The reference bar: its CPU/CUDA kernels compute genuine fp32
(/root/reference/src/fwht/cuda/fwht_cuda_kernel.cu:75-146 templates on
the scalar type) -- the comparable mode is "highest".

Run: python benchmarks/precision_check.py [--sizes 4096 16384] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def _maybe_force_cpu():
    import sys as _sys

    if "--cpu" in _sys.argv:
        _sys.argv.remove("--cpu")
        import jax as _jax

        _jax.config.update("jax_platforms", "cpu")


_maybe_force_cpu()

import argparse
import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def chain_time(f, s1, u, s2, x, iters):
    """Difference-timed seconds per application over an on-device chain."""

    @functools.partial(jax.jit, static_argnames="n")
    def chained(x, n):
        y = jax.lax.fori_loop(0, n, lambda i, v: f(s1, u, s2, v), x)
        return jnp.sum(y)

    def run(n):
        float(chained(x, n))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(chained(x, n))
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = run(iters)
    t2 = run(2 * iters)
    return max(t2 - t1, 1e-9) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--sizes", type=int, nargs="*", default=[1024, 4096, 16384])
    args = ap.parse_args()

    from whvi_tpu.ops.cpu_oracle import whvi_mul_cpp
    from whvi_tpu.ops.hadamard import fwht_factors, fwht_kron
    from whvi_tpu.utils.profiling import mfu, whvi_mul_flops

    def make_f(prec):
        def f(s1, u, s2, x):
            return s1 * fwht_kron(
                u * fwht_kron(s2 * x, precision=prec), precision=prec
            )

        return f

    backend = jax.default_backend()
    print(f"backend={backend} device={jax.devices()[0]}")
    for D in args.sizes:
        B = args.batch
        rng = np.random.RandomState(0)
        s1 = (rng.randn(D) * 0.01).astype(np.float32)
        u = rng.randn(D).astype(np.float32)
        s2 = (rng.randn(D) * 0.01).astype(np.float32)
        xe = rng.randn(8, D).astype(np.float32)  # small batch for the oracle
        ref = whvi_mul_cpp(s1, u, s2, xe.astype(np.float64))
        scale = np.max(np.abs(ref))

        # norm-preserving random-sign diagonals for the timing chain
        c0 = D ** (-1.0 / 3.0)
        sk = jax.random.split(jax.random.PRNGKey(7), 3)
        sgn = lambda k: c0 * jnp.where(
            jax.random.bernoulli(k, 0.5, (D,)), 1.0, -1.0
        ).astype(jnp.float32)
        c1, c2, c3 = sgn(sk[0]), sgn(sk[1]), sgn(sk[2])
        mk = jax.jit(lambda k, s: jax.random.normal(k, s), static_argnums=1)
        xt = mk(jax.random.PRNGKey(3), (B, D))

        flops = whvi_mul_flops(D, B)
        bytes_moved = 2 * B * D * 4
        for prec in ("default", "highest", "bf16"):
            f = make_f(prec)
            y = np.asarray(jax.jit(f)(s1, u, s2, xe), dtype=np.float64)
            rel = float(np.max(np.abs(y - ref)) / scale)
            t = chain_time(f, c1, c2, c3, xt, args.iters)
            row = {
                "D": D,
                "B": B,
                "precision": prec,
                "rel_err_vs_f64": float(f"{rel:.3e}"),
                "us_per_call": round(t * 1e6, 1),
                "GBps": round(bytes_moved / t / 1e9, 1),
                "TFLOPs": round(flops / t / 1e12, 1),
                "mfu": mfu(flops / t, jax.devices()[0], prec),
                "factors": list(fwht_factors(D)),
            }
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
