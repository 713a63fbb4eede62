"""Tests for the Hadamard numerics core.

Mirrors the reference's oracle pattern (test/walsh.py: compare every
backend against dense ``build_H(D) @ a``) and adds the structural checks
the reference lacks (SURVEY.md section 4): gradient checks and the
two-sided WHVI product vs its dense materialization.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from whvi_tpu.ops import (
    build_H,
    fwht,
    fwht_butterfly,
    fwht_kron,
    is_pow_of_2,
    kl_diag_normal,
    next_pow_of_2,
    whvi_dense,
    whvi_mul,
    whvi_mul_dense_oracle,
)


def test_pow2_helpers():
    assert [n for n in range(1, 20) if is_pow_of_2(n)] == [1, 2, 4, 8, 16]
    assert not is_pow_of_2(0)
    assert not is_pow_of_2(-4)
    # next_pow_of_2 has no float-log precision trap (reference needed a
    # guard for exact powers of two, src/weights.py:150-155)
    assert next_pow_of_2(1) == 1
    assert next_pow_of_2(2) == 2
    assert next_pow_of_2(3) == 4
    assert next_pow_of_2(8) == 8
    assert next_pow_of_2(9) == 16
    assert next_pow_of_2(4096) == 4096


def test_build_H_matches_recursive_sylvester():
    # Recursive Sylvester construction as an independent oracle
    # (the reference builds H this way, src/utils.py:74-101).
    def sylvester(D):
        H = np.array([[1.0]])
        while H.shape[0] < D:
            H = np.block([[H, H], [H, -H]])
        return H

    for D in (1, 2, 4, 8, 32, 128):
        np.testing.assert_array_equal(np.asarray(build_H(D)), sylvester(D))


def test_build_H_properties():
    for D in (2, 16, 64):
        H = np.asarray(build_H(D))
        np.testing.assert_array_equal(H, H.T)
        np.testing.assert_array_equal(H @ H, D * np.eye(D))


def test_hand_computed_4vector():
    # Reference test/walsh.py:11-20 hand-computed case.
    a = jnp.array([1.0, 0.0, 1.0, 0.0])
    expected = jnp.array([2.0, 2.0, 0.0, 0.0])
    np.testing.assert_allclose(fwht_butterfly(a), expected)
    np.testing.assert_allclose(fwht_kron(a), expected)


@pytest.mark.parametrize("D", [2, 4, 8, 32, 128, 256, 1024])
def test_fwht_matches_dense_oracle(D):
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (5, D))
    oracle = x @ np.asarray(build_H(D))  # H symmetric: x @ H == (H @ x^T)^T
    np.testing.assert_allclose(
        np.asarray(fwht_butterfly(x)), oracle, rtol=1e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(fwht_kron(x)), oracle, rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("mf", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("D", [64, 512])
def test_fwht_kron_small_max_factor_multi_stage(D, mf):
    # Force >= 2 and >= 3 Kronecker factors (down to all-H_2 factors at
    # mf=2) to cover the multi-axis path.
    key = jax.random.PRNGKey(1)
    x = jax.random.normal(key, (3, D))
    oracle = x @ np.asarray(build_H(D))
    np.testing.assert_allclose(
        np.asarray(fwht_kron(x, max_factor=mf)), oracle, rtol=1e-5, atol=1e-4
    )


def test_fwht_batch_dims():
    key = jax.random.PRNGKey(2)
    x = jax.random.normal(key, (2, 3, 4, 16))
    got = fwht(x)
    flat = fwht(x.reshape(-1, 16)).reshape(x.shape)
    np.testing.assert_allclose(np.asarray(got), np.asarray(flat), rtol=1e-6)


def test_fwht_involution_scaled():
    # H @ H = D I  =>  fwht(fwht(x)) == D * x
    key = jax.random.PRNGKey(3)
    D = 64
    x = jax.random.normal(key, (7, D))
    np.testing.assert_allclose(
        np.asarray(fwht(fwht(x))), D * np.asarray(x), rtol=1e-5, atol=1e-4
    )


def test_fwht_grad_is_self_adjoint():
    # VJP of fwht is fwht (H = H^T); reference states this for CUDA in
    # src/fwht/cuda/fwht.py:14-16.
    key = jax.random.PRNGKey(4)
    D = 32
    x = jax.random.normal(key, (D,))
    g = jax.random.normal(jax.random.PRNGKey(5), (D,))
    for impl in (fwht_butterfly, fwht_kron):
        _, vjp = jax.vjp(impl, x)
        (got,) = vjp(g)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(fwht(g)), rtol=1e-5, atol=1e-4
        )


def test_fwht_check_grads():
    from jax.test_util import check_grads

    x = jax.random.normal(jax.random.PRNGKey(6), (3, 16))
    check_grads(fwht_butterfly, (x,), order=2, modes=["fwd", "rev"])
    check_grads(fwht_kron, (x,), order=2, modes=["fwd", "rev"])


def test_kl_diag_normal_matches_scipy_formula():
    # Independent scalar-formula oracle (stddev-parameterized).
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    D = 11
    mu = jax.random.normal(k1, (D,))
    sigma = jax.nn.softplus(jax.random.normal(k2, (D,)))
    lam = 3.0  # prior variance => prior stddev sqrt(lam)
    got = kl_diag_normal(mu, sigma, 0.0, jnp.sqrt(lam))
    mu_n, s_n = np.asarray(mu), np.asarray(sigma)
    expect = sum(
        np.log(np.sqrt(lam) / s)
        + (s**2 + m**2) / (2 * lam)
        - 0.5
        for m, s in zip(mu_n, s_n)
    )
    np.testing.assert_allclose(float(got), expect, rtol=1e-5)


def test_kl_diag_normal_zero_when_equal():
    mu = jnp.array([0.3, -1.2, 4.0])
    sigma = jnp.array([0.5, 1.5, 2.0])
    assert abs(float(kl_diag_normal(mu, sigma, mu, sigma))) < 1e-6


def test_kl_normal_scalar():
    # Scalar KL (reference src/utils.py:36-46, stddev-consistent here):
    # closed form for N(m1, s1^2) || N(m2, s2^2).
    from whvi_tpu.ops import kl_normal

    m1, s1, m2, s2 = 0.7, 0.4, -0.2, 1.3
    expect = (
        np.log(s2 / s1) + (s1**2 + (m1 - m2) ** 2) / (2 * s2**2) - 0.5
    )
    np.testing.assert_allclose(float(kl_normal(m1, s1, m2, s2)), expect,
                               rtol=1e-6)
    # zero at equality; consistent with the diagonal form
    assert abs(float(kl_normal(1.1, 0.9, 1.1, 0.9))) < 1e-7
    np.testing.assert_allclose(
        float(kl_normal(m1, s1, m2, s2)),
        float(kl_diag_normal(jnp.array([m1]), jnp.array([s1]), m2, s2)),
        rtol=1e-6,
    )


@pytest.mark.parametrize("B", [1, 3, 100])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_whvi_mul_matches_dense(D, B):
    # Oracle: the dense-H product s1 * ((u * ((s2 * x) @ H)) @ H) in
    # float64. u is scaled by 64/D so the output stays O(1) at every D.
    key = jax.random.PRNGKey(8)
    ks = jax.random.split(key, 4)
    s1 = jax.random.normal(ks[0], (D,)) * 0.1
    s2 = jax.random.normal(ks[1], (D,)) * 0.1
    u = jax.random.normal(ks[2], (D,)) * (64.0 / D)
    x = jax.random.normal(ks[3], (B, D))
    got = whvi_mul(s1, u, s2, x)
    H = np.asarray(build_H(D), np.float64)
    s1n, s2n, un, xn = (np.asarray(a, np.float64) for a in (s1, s2, u, x))
    oracle = s1n * ((un * ((s2n * xn) @ H)) @ H)
    np.testing.assert_allclose(np.asarray(got), oracle, rtol=1e-4, atol=1e-4)


def _whvi_args(D, B, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    return (
        jax.random.normal(ks[0], (D,)) * 0.1,
        jax.random.normal(ks[1], (D,)),
        jax.random.normal(ks[2], (D,)) * 0.1,
        jax.random.normal(ks[3], (B, D)),
    ), jax.random.normal(ks[4], (B, D))


@pytest.mark.parametrize("D", [16, 256])
def test_whvi_mul_vjp_matches_dense_oracle(D):
    # The VJP of the transform product must equal the VJP of the
    # materialized-W oracle for every argument, in true fp32.
    args, g = _whvi_args(D, 5, seed=40)
    with jax.default_matmul_precision("highest"):
        got = jax.vjp(whvi_mul, *args)[1](g)
        ref = jax.vjp(whvi_mul_dense_oracle, *args)[1](g)
    for a, b in zip(got, ref):
        scale = float(jnp.max(jnp.abs(b)))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5 * scale
        )


@pytest.mark.parametrize("D", [16, 256])
def test_whvi_mul_loss_grad_matches_dense_oracle(D):
    # A scalar loss through the product: gradients w.r.t. all four
    # arguments agree with the dense oracle's, in true fp32.
    args, target = _whvi_args(D, 7, seed=41)

    def loss(f):
        return lambda *a: jnp.sum(jnp.tanh(f(*a) - target) ** 2)

    with jax.default_matmul_precision("highest"):
        got = jax.grad(loss(whvi_mul), argnums=(0, 1, 2, 3))(*args)
        ref = jax.grad(loss(whvi_mul_dense_oracle), argnums=(0, 1, 2, 3))(
            *args
        )
    for a, b in zip(got, ref):
        scale = float(jnp.max(jnp.abs(b)))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5 * scale
        )


def test_whvi_dense_is_not_diagonal():
    # Guard against re-introducing the reference's degenerate-W bug
    # (SURVEY.md section 0 bug 1: its sampled W is diagonal to ~1e-12).
    key = jax.random.PRNGKey(9)
    D = 16
    ks = jax.random.split(key, 3)
    s1 = jax.random.normal(ks[0], (D,)) * 0.1 + 1.0
    s2 = jax.random.normal(ks[1], (D,)) * 0.1 + 1.0
    u = jax.random.normal(ks[2], (D,)) + 1.0
    W = np.asarray(whvi_dense(s1, u, s2))
    off = W - np.diag(np.diag(W))
    assert np.abs(off).max() > 1e-2, "W degenerated to a diagonal matrix"


def test_whvi_dense_matches_matrix_formula():
    key = jax.random.PRNGKey(10)
    D = 32
    ks = jax.random.split(key, 3)
    s1 = jax.random.normal(ks[0], (D,))
    s2 = jax.random.normal(ks[1], (D,))
    u = jax.random.normal(ks[2], (D,))
    H = np.asarray(build_H(D))
    expect = np.diag(np.asarray(s1)) @ H @ np.diag(np.asarray(u)) @ H @ np.diag(np.asarray(s2))
    np.testing.assert_allclose(
        np.asarray(whvi_dense(s1, u, s2)), expect, rtol=1e-4, atol=1e-4
    )


def test_whvi_mul_stacked_broadcast():
    # (stack, D) diagonals against (B, 1, D) activations — the stacked
    # matrix path with no Python loop.
    key = jax.random.PRNGKey(11)
    D, B, S = 16, 5, 3
    ks = jax.random.split(key, 4)
    s1 = jax.random.normal(ks[0], (S, D))
    s2 = jax.random.normal(ks[1], (S, D))
    u = jax.random.normal(ks[2], (S, D))
    x = jax.random.normal(ks[3], (B, D))
    got = whvi_mul(s1, u, s2, x[:, None, :])  # (B, S, D)
    assert got.shape == (B, S, D)
    for s in range(S):
        oracle = whvi_mul_dense_oracle(s1[s], u[s], s2[s], x)
        np.testing.assert_allclose(
            np.asarray(got[:, s]), np.asarray(oracle), rtol=1e-4, atol=1e-4
        )


def test_matmul_diag_helpers():
    # oracle = dense diag matmul (reference test/utils.py:8-20 pattern)
    from whvi_tpu.ops import matmul_diag_left, matmul_diag_right

    key = jax.random.PRNGKey(30)
    d = jax.random.normal(key, (5,))
    A = jax.random.normal(jax.random.PRNGKey(31), (5, 7))
    np.testing.assert_allclose(
        np.asarray(matmul_diag_left(d, A)),
        np.diag(np.asarray(d)) @ np.asarray(A),
        rtol=1e-6,
    )
    d2 = jax.random.normal(jax.random.PRNGKey(32), (7,))
    np.testing.assert_allclose(
        np.asarray(matmul_diag_right(A, d2)),
        np.asarray(A) @ np.diag(np.asarray(d2)),
        rtol=1e-6,
    )
    # batched
    db = jax.random.normal(jax.random.PRNGKey(33), (3, 5))
    Ab = jax.random.normal(jax.random.PRNGKey(34), (3, 5, 7))
    out = matmul_diag_left(db, Ab)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(out[i]),
            np.diag(np.asarray(db[i])) @ np.asarray(Ab[i]),
            rtol=1e-6,
        )


def test_fwht_kron_bf16_precision_mode():
    # precision="bf16": H factors stored exact in bf16, activations round
    # to bf16 at each dot operand, fp32 accumulation — small relative
    # error, fp32 output dtype.
    from whvi_tpu.ops.hadamard import build_H, fwht_kron

    for D in (64, 512):
        x = jax.random.normal(jax.random.PRNGKey(1), (4, D))
        lo = fwht_kron(x, precision="bf16")
        oracle = x @ build_H(D)
        assert lo.dtype == x.dtype
        rel = float(
            jnp.max(jnp.abs(lo - oracle)) / jnp.max(jnp.abs(oracle))
        )
        assert rel < 2e-2, rel


def test_build_H_rows_matches_dense_slice():
    # column path uses only the surviving rows — must equal the dense
    # slice at every size including non-trivial row counts
    from whvi_tpu.ops.hadamard import build_H, build_H_rows

    for D, r in ((8, 3), (64, 1), (256, 5)):
        np.testing.assert_array_equal(
            np.asarray(build_H_rows(D, r)), np.asarray(build_H(D))[:r]
        )
