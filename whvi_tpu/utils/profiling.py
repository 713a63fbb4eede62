"""Profiling & timing utilities.

Replaces the reference's bespoke ``st_time`` decorator and reflective
``Benchmark`` runner (benchmarks/classes.py:4-37) with:

- :class:`Benchmark` — the same reflective runner (methods named
  ``benchmark_*`` are discovered and timed), kept for familiarity;
- :func:`timed` — wall-clock decorator (st_time equivalent) that
  block-until-readies jax outputs so device work is actually counted
  (the reference needed manual ``torch.cuda.synchronize``,
  benchmarks/walsh_plot.py:44);
- :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory;
- :func:`chain_time` — per-op seconds via an on-device dependent chain
  with difference timing (cancels the fixed dispatch and fetch cost);
- :func:`peak_flops` / :func:`hbm_bytes_per_s` / :func:`mfu` — the
  per-device peak table that roofline shares divide by.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "Benchmark",
    "timed",
    "trace",
    "chain_time",
    "fwht_flops",
    "whvi_mul_flops",
    "whvi_layer_fwd_flops",
    "whvi_layer_train_flops",
    "net_train_step_flops",
    "elbo_step_flops",
    "DEVICE_PEAKS",
    "peak_flops",
    "hbm_bytes_per_s",
    "mfu",
]

# ------------------------------------------------------------- roofline
# Dense (no sparsity) peaks per card, keyed by jax ``device_kind``.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column (80 GB
# HBM3): 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s fp32 (CUDA
# cores, outside the tensor cores), 3.35 TB/s HBM. The rates assume the
# card's full 700 W power limit; a card capped below it cannot hold its
# top clock, so report the power limit beside any share of these.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,
        "tf32": 495e12,
        "fp32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}

# What the operands of an fp32 dot are in each ``fwht_kron`` precision
# mode on the card: "bf16" stores H in bfloat16, "default" lets cuBLAS
# run fp32 operands in TF32, "highest" keeps true fp32.
_MODE_DTYPE = {"bf16": "bf16", "default": "tf32", "highest": "fp32"}


def _peaks(device_kind: str) -> dict:
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device_kind {device_kind!r}; add the card "
            f"to DEVICE_PEAKS (known: {sorted(DEVICE_PEAKS)})"
        ) from None


def peak_flops(device_kind: str, precision: str = "default") -> float:
    """Peak FLOP/s of one card for a ``fwht_kron`` precision mode."""
    if precision not in _MODE_DTYPE:
        raise ValueError(
            f"precision must be one of {tuple(_MODE_DTYPE)}, got {precision!r}"
        )
    return _peaks(device_kind)[_MODE_DTYPE[precision]]


def hbm_bytes_per_s(device_kind: str) -> float:
    """Peak device-memory bandwidth of one card, bytes/s."""
    return _peaks(device_kind)["hbm_bytes_per_s"]


def mfu(flops_per_s: float, device=None, precision: str = "default"):
    """``flops_per_s`` over the card's peak for ``precision``; None on the
    CPU, where there is no peak to divide by. ``device`` defaults to
    ``jax.devices()[0]``; a GPU missing from :data:`DEVICE_PEAKS` raises."""
    device = jax.devices()[0] if device is None else device
    if device.platform == "cpu":
        return None
    return flops_per_s / peak_flops(device.device_kind, precision)


def fwht_flops(D: int, batch: int) -> int:
    """Matmul FLOPs of one Kronecker-factor FWHT over a ``(batch, D)``
    operand: each factor ``f_i`` contributes a ``(batch * D / f_i, f_i)
    @ (f_i, f_i)`` contraction = ``2 * batch * D * f_i`` FLOPs, so the
    transform totals ``2 * batch * D * sum(f_i)``. Elementwise work is
    excluded (the MFU convention counts matmul FLOPs only)."""
    from whvi_tpu.ops.hadamard import fwht_factors

    return 2 * batch * D * sum(fwht_factors(D))


def whvi_mul_flops(D: int, batch: int) -> int:
    """Matmul FLOPs of one product ``s1 * H(u * H(s2 * x))`` over a
    ``(batch, D)`` operand: exactly two FWHTs (diagonals are elementwise
    work)."""
    return 2 * fwht_flops(D, batch)


def whvi_layer_fwd_flops(
    D: int, batch: int, stack: int = 1, lrt: bool = True
) -> int:
    """Matmul FLOPs of one FORWARD pass through one WHVI layer, per MC
    sample: exactly ONE fused product. The textbook LRT evaluates two
    products (``W(mu) x + W(sigma*eps) x``, reference
    src/weights.py:87-93) but ``W_bar(u)`` is linear in ``u`` so this
    implementation merges them into one product with
    ``u = mu + sigma*eps`` (models/weights.py SquarePow2Matrix.apply) --
    LRT and explicit sampling cost the same here. (The first version of
    this counter charged the LRT 2 products; the MFU audit it feeds
    caught the overcount as a >100% serving MFU row.)"""
    del lrt  # same cost either way (merged-u LRT)
    return whvi_mul_flops(D, batch) * stack


def whvi_layer_train_flops(
    D: int, batch: int, stack: int = 1, lrt: bool = True
) -> int:
    """Matmul FLOPs of one TRAIN step through one WHVI layer, per MC sample.

    Backward: H is a *constant*, so the product's VJP w.r.t. ``x`` is
    one more product of the same cost (self-adjoint transform) and the
    diagonal/param gradients are elementwise reductions with no
    matmuls -- fwd+bwd is exactly 2x forward (unlike dense layers' 3x).
    """
    return 2 * whvi_layer_fwd_flops(D, batch, stack, lrt)


def net_train_step_flops(net, batch: int, n_samples: int | None = None) -> int:
    """Analytic matmul FLOPs of one ELBO train step of an arbitrary
    ``WHVINetwork`` (introspects each WHVI layer's matrix construction;
    column layers are O(n) with no matmul and excluded)."""
    S = getattr(net, "train_samples", 1) if n_samples is None else n_samples
    total = 0
    for layer in net.layers:
        if not hasattr(layer, "matrix"):
            continue
        m = layer.matrix
        name = type(m).__name__
        lrt = getattr(layer, "lrt", True)
        if name == "SquarePow2Matrix":
            total += whvi_layer_train_flops(m.D, batch, lrt=lrt)
        elif name == "StackedMatrix":
            D_in, _, _, stack = m.dims
            total += whvi_layer_train_flops(D_in, batch, stack=stack, lrt=lrt)
        elif name == "PaddedSquareMatrix":
            total += whvi_layer_train_flops(m.D, batch, lrt=lrt)
    return S * total


def elbo_step_flops(
    square_dims: list[int] | tuple[int, ...],
    batch: int,
    n_samples: int,
    lrt: bool = True,
) -> int:
    """Analytic matmul FLOPs of one ELBO train step of a WHVI MLP whose
    Bayesian layers are square ``D x D`` (the scaling-benchmark model);
    column output layers are O(D) and excluded (<1% at any measured D).
    """
    per_sample = sum(
        whvi_layer_train_flops(D, batch, lrt=lrt) for D in square_dims
    )
    return n_samples * per_sample


def timed(fn: Callable) -> Callable:
    """Print wall-clock of each call, device-synchronized."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        print(f"{fn.__name__}: {time.perf_counter() - t0:.6f}s", flush=True)
        return out

    return wrapper


class Benchmark:
    """Reflectively run all ``benchmark_*`` methods (reference
    benchmarks/classes.py:28-37 pattern)."""

    def run(self) -> dict:
        results = {}
        for name in sorted(dir(self)):
            if not name.startswith("benchmark_"):
                continue
            fn = getattr(self, name)
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out) if out is not None else None
            results[name] = time.perf_counter() - t0
            print(f"{name}: {results[name]:.6f}s", flush=True)
        return results


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/whvi_trace"):
    """jax.profiler trace context; view with TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def chain_time(fn: Callable, x, iters: int = 200, reps: int = 3) -> float:
    """Per-application seconds of ``x -> fn(x)`` over an on-device
    dependent chain, difference-timed (t(2N) - t(N)) to cancel fixed
    dispatch/fetch latency.

    Completion is forced by fetching a full on-device reduction of the
    final iterate, which waits for every iteration. The reduction runs
    once per *chain*, so its cost amortizes to ~nothing per iteration
    and cancels in the difference anyway."""

    @functools.partial(jax.jit, static_argnames="n")
    def chained(v, n):
        w = jax.lax.fori_loop(0, n, lambda i, w: fn(w), v)
        return jax.tree.reduce(
            lambda acc, l: acc + jnp.sum(l), w, jnp.zeros(())
        )

    def run(n):
        float(chained(x, n))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(chained(x, n))
            best = min(best, time.perf_counter() - t0)
        return best

    return max(run(2 * iters) - run(iters), 1e-9) / iters
