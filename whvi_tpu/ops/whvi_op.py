"""The core WHVI structured-matrix operator.

A WHVI weight matrix is the structured reparameterization (reference
report/introduction.tex:9-14, src/weights.py:66-85):

    W_bar(u) = S1 . H . diag(u) . H . S2          (S1, S2 diagonal)

Rather than materializing ``W_bar`` (the reference does, via two row-wise
matrix FWHTs — which provably collapses its W to a diagonal matrix, see
SURVEY.md section 0 bug 1), we apply it directly to activations:

    y = x @ W_bar(u)^T
      = s1 * fwht(u * fwht(s2 * x))        [per row of x; H = H^T]

because ``W_bar(u)^T = S2 H diag(u) H S1`` and a row-vector product with a
symmetric matrix is the last-axis vector transform. This is ``O(D log D)``
(butterfly) / Kronecker-factor matmul work and never touches a ``D x D``
intermediate.

Broadcasting: ``s1, u, s2`` may carry leading axes that broadcast against
``x``'s leading axes. The stacked non-square matrix (reference
src/weights.py:111-208) becomes parameters of shape ``(stack, D)`` applied
to ``x[..., None, :]`` — no Python loop over blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from whvi_tpu.ops.hadamard import build_H, fwht

__all__ = [
    "whvi_mul",
    "whvi_dense",
    "whvi_mul_dense_oracle",
]


def whvi_mul(
    s1: jax.Array, u: jax.Array, s2: jax.Array, x: jax.Array
) -> jax.Array:
    """Compute ``x @ W_bar(u)^T`` with ``W_bar(u) = S1 H diag(u) H S2``.

    Args:
      s1, u, s2: diagonals, shape ``(D,)`` or any shape broadcastable
        against ``x``'s leading axes (e.g. ``(stack, D)``).
      x: activations ``(..., D)``.

    Returns:
      ``(..., D)`` (after broadcasting leading axes), same semantics as the
      reference's ``w_bar``-based products (src/weights.py:66-93) but with
      the paper-correct two-sided transform.
    """
    return s1 * fwht(u * fwht(s2 * x))


def whvi_dense(
    s1: jax.Array, u: jax.Array, s2: jax.Array, precision: str | None = None
) -> jax.Array:
    """Materialize ``W_bar(u) = diag(s1) H diag(u) H diag(s2)`` densely.

    Test oracle + the column-matrix path (reference src/weights.py:244-248
    needs the materialized matrix to reshape it into a column). ``s1, u,
    s2`` may carry leading batch axes. ``precision`` is the operand
    mode of the single H @ (.) matmul (None = the module default of
    ops.hadamard; oracles should pass "highest").
    """
    from whvi_tpu.ops.hadamard import _DEFAULT_PRECISION, _dot_precision

    if precision is None:
        precision = _DEFAULT_PRECISION
    D = s1.shape[-1]
    acc = jnp.float32 if s1.dtype.itemsize <= 4 else s1.dtype
    H = build_H(D, acc)
    inner = u[..., :, None] * H * s2[..., None, :]  # diag(u) H diag(s2)
    return s1[..., :, None] * jnp.matmul(
        H,
        inner,
        preferred_element_type=acc,
        precision=_dot_precision(precision),
    ).astype(s1.dtype)


def whvi_mul_dense_oracle(
    s1: jax.Array, u: jax.Array, s2: jax.Array, x: jax.Array
) -> jax.Array:
    """Oracle: ``x @ W_bar(u)^T`` via the dense matrix, in full float32
    whatever the module default (a GPU would otherwise run the products
    in TF32). Tests only."""
    W = whvi_dense(s1, u, s2, precision="highest")
    return jnp.einsum(
        "...ij,...j->...i", W, x, precision=jax.lax.Precision.HIGHEST
    )
