"""Structured variational weight matrices (functional init/apply pairs).

Counterparts of the reference's ``WHVISquarePow2Matrix``,
``WHVIStackedMatrix`` and ``WHVIColumnMatrix`` (src/weights.py:13-251),
redesigned as stateless objects over parameter pytrees:

- parameters are plain dicts of arrays; PRNG keys are explicit (the
  reference samples through torch's hidden global RNG, weights.py:82, 92);
- the stacked matrix stores its blocks as leading-axis-``stack`` arrays and
  applies all blocks in one broadcasted ``whvi_mul`` (the reference loops a
  ``ModuleList``, weights.py:171-180);
- all math is the paper-correct two-sided transform
  ``W = S1 H diag(g) H S2`` — the reference's row-wise composition
  collapses to a diagonal matrix (verified by execution, SURVEY.md
  section 0 bug 1) and is deliberately NOT reproduced.

Every matrix exposes:
  ``init(key) -> params``
  ``kl(params) -> scalar``          KL(q(g) || N(0, lambda I)) summed
  ``sample_W(params, key)``         explicit dense weight sample (oracle /
                                    column path)
  ``apply(params, x, key, lrt=...)`` y = x @ W^T with W ~ q, via explicit
                                    sampling or the local reparameterization
                                    trick (reference weights.py:87-93)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from whvi_tpu.ops.hadamard import (
    build_H_rows,
    fwht,
    is_pow_of_2,
    kl_diag_normal,
    next_pow_of_2,
)
from whvi_tpu.ops.whvi_op import whvi_dense, whvi_mul

__all__ = [
    "SquarePow2Matrix",
    "StackedMatrix",
    "ColumnMatrix",
    "PaddedSquareMatrix",
    "setup_dimensions",
]


def setup_dimensions(n_in: int, n_out: int) -> tuple[int, int, int, int]:
    """Dimensions for a non-square WHVI matrix built from square blocks.

    Returns ``(D_in, D_out, padding, stack)``: inputs are zero-padded by
    ``padding`` to ``D_in = next_pow_of_2(n_in)``; ``stack`` square
    ``D_in x D_in`` blocks are stacked vertically giving ``D_out = stack *
    D_in >= n_out`` rows, then outputs are truncated to ``n_out``.

    Same contract as reference ``setup_dimensions`` (src/weights.py:135-160)
    — verified behavior: (3,16)->(4,16,1,4), (13,128)->(16,128,3,8),
    (128,128)->(128,128,0,1), (8,10)->(8,16,0,2) — but with exact integer
    bit math instead of ``math.log`` plus a float-precision guard.
    """
    D_in = next_pow_of_2(n_in)
    padding = D_in - n_in
    stack = -(-n_out // D_in)  # ceil division
    D_out = stack * D_in
    return D_in, D_out, padding, stack


def _g_sigma(g_rho: jax.Array) -> jax.Array:
    """Posterior stddev sigma = softplus(rho) (reference weights.py:43-50)."""
    return jax.nn.softplus(g_rho)


@dataclasses.dataclass(frozen=True)
class SquarePow2Matrix:
    """``D x D`` WHVI variational matrix, ``D`` a power of two.

    Parameters (reference init, src/weights.py:28-32):
      ``s1, s2 ~ 0.01 * N(0, 1)`` i.i.d. per element,
      ``g_mu = 0``, ``g_rho ~ U(-3, -2)``;
    posterior ``q(g) = N(g_mu, diag(softplus(g_rho)^2))``, prior
    ``N(0, lambda I)``.
    """

    D: int
    lambda_: float = 1e-5
    # stddev of the S1/S2 init: the reference uses 0.01 (weights.py:29-30),
    # which makes the W scale ~1e-4 and starves the likelihood gradient
    # (posterior collapse; see TrainConfig.kl_warmup_steps). "auto" uses
    # D**-0.5, the variance-preserving choice for this parameterization
    # (Var(W_ij) = s1^2 s2^2 D sigma_g^2 = sigma_g^2 / D at s = D^-1/2).
    s_init: float | str = 0.01

    def __post_init__(self):
        if not is_pow_of_2(self.D):
            raise ValueError(f"D must be a power of 2, got {self.D}")

    @property
    def n_in(self) -> int:
        return self.D

    @property
    def n_out(self) -> int:
        return self.D

    def init(self, key: jax.Array, dtype=jnp.float32) -> dict:
        k1, k2, k3 = jax.random.split(key, 3)
        D = self.D
        scale = D**-0.5 if self.s_init == "auto" else float(self.s_init)
        return {
            "s1": scale * jax.random.normal(k1, (D,), dtype),
            "s2": scale * jax.random.normal(k2, (D,), dtype),
            "g_mu": jnp.zeros((D,), dtype),
            "g_rho": jax.random.uniform(
                k3, (D,), dtype, minval=-3.0, maxval=-2.0
            ),
        }

    def kl(self, params: dict, lambda_=None) -> jax.Array:
        # ``lambda_``: optional prior-variance override — may be a
        # TRACED scalar (the config-stacked protocol rides per-replica
        # lambdas down this path; None keeps the static layer value)
        lam = self.lambda_ if lambda_ is None else lambda_
        return kl_diag_normal(
            params["g_mu"],
            _g_sigma(params["g_rho"]),
            0.0,
            jnp.sqrt(jnp.asarray(lam, params["g_mu"].dtype)),
        )

    def sample_g(self, params: dict, key: jax.Array) -> jax.Array:
        eps = jax.random.normal(key, params["g_mu"].shape, params["g_mu"].dtype)
        return params["g_mu"] + _g_sigma(params["g_rho"]) * eps

    def sample_W(self, params: dict, key: jax.Array) -> jax.Array:
        """Explicit dense sample ``W = S1 H diag(g) H S2`` (oracle path)."""
        g = self.sample_g(params, key)
        return whvi_dense(params["s1"], g, params["s2"])

    def apply(
        self,
        params: dict,
        x: jax.Array,
        key: jax.Array,
        lrt: bool = True,
        per_example_noise: bool = False,
    ) -> jax.Array:
        """``y = x @ W^T`` with ``W ~ q``, never materializing ``W``.

        LRT (default, reference weights.py:87-93):
          ``y = x W_bar(mu)^T + x W_bar(sigma * eps)^T`` with one
          ``eps ~ N(0, I_D)`` per call — shared across the batch,
          matching the reference's variance semantics — or, with
          ``per_example_noise``, an independent eps per batch element
          (the variance-reduced form of the local reparameterization
          trick; same marginals, lower-variance gradients).

        ``W_bar(u)`` is linear in ``u``, so the LRT's two products
        collapse exactly into one: ``x W_bar(mu)^T + x W_bar(s*eps)^T
        = x W_bar(mu + s*eps)^T`` (the reference evaluates both,
        weights.py:93 — twice the transforms for the same value).
        Explicit path: ``y = x W_bar(g)^T`` with ``g ~ q``.
        """
        s1, s2 = params["s1"], params["s2"]
        if lrt:
            shape = (
                x.shape[:-1] + params["g_mu"].shape
                if per_example_noise
                else params["g_mu"].shape
            )
            eps = jax.random.normal(key, shape, x.dtype)
            u = params["g_mu"] + _g_sigma(params["g_rho"]) * eps
            return whvi_mul(s1, u, s2, x)
        g = self.sample_g(params, key)
        return whvi_mul(s1, g, s2, x)

    def apply_given_g(
        self, params: dict, x: jax.Array, g: jax.Array
    ) -> jax.Array:
        """Deterministic forward with an explicit ``g`` (MCMC/golden-
        sampler path: g is the sampled variable, not drawn from q)."""
        return whvi_mul(params["s1"], g, params["s2"], x)


@dataclasses.dataclass(frozen=True)
class StackedMatrix:
    """Arbitrary ``(n_in, n_out)`` WHVI matrix as stacked square blocks.

    Reference: ``WHVIStackedMatrix`` (src/weights.py:111-208). Inputs are
    zero-padded to ``D_in``, each of the ``stack`` blocks maps
    ``D_in -> D_in``, block outputs are concatenated and truncated to
    ``n_out``. Here block parameters live on a leading ``stack`` axis and
    all blocks run in one broadcasted ``whvi_mul`` — no Python loop.
    """

    n_in: int
    n_out: int
    lambda_: float = 1e-5
    s_init: float | str = 0.01

    @property
    def dims(self) -> tuple[int, int, int, int]:
        return setup_dimensions(self.n_in, self.n_out)

    def init(self, key: jax.Array, dtype=jnp.float32) -> dict:
        D_in, _, _, stack = self.dims
        block = SquarePow2Matrix(D_in, self.lambda_, self.s_init)
        return jax.vmap(lambda k: block.init(k, dtype))(
            jax.random.split(key, stack)
        )

    def kl(self, params: dict, lambda_=None) -> jax.Array:
        # ``lambda_``: optional prior-variance override — may be a
        # TRACED scalar (the config-stacked protocol rides per-replica
        # lambdas down this path; None keeps the static layer value)
        lam = self.lambda_ if lambda_ is None else lambda_
        return kl_diag_normal(
            params["g_mu"],
            _g_sigma(params["g_rho"]),
            0.0,
            jnp.sqrt(jnp.asarray(lam, params["g_mu"].dtype)),
        )

    def sample_g(self, params: dict, key: jax.Array) -> jax.Array:
        eps = jax.random.normal(key, params["g_mu"].shape, params["g_mu"].dtype)
        return params["g_mu"] + _g_sigma(params["g_rho"]) * eps

    def sample_W(self, params: dict, key: jax.Array) -> jax.Array:
        """Dense ``(n_out, n_in)`` sample: vertical stack of block samples,
        truncated (reference weights.py:171-177)."""
        g = self.sample_g(params, key)  # (stack, D_in)
        W_blocks = whvi_dense(params["s1"], g, params["s2"])  # (stack, D, D)
        D_in, D_out, _, _ = self.dims
        W = W_blocks.reshape(D_out, D_in)[: self.n_out]
        return W[:, : self.n_in]

    def _pad(self, x: jax.Array) -> jax.Array:
        D_in, _, padding, _ = self.dims
        if padding == 0:
            return x
        pad_widths = [(0, 0)] * (x.ndim - 1) + [(0, padding)]
        return jnp.pad(x, pad_widths)

    def apply(
        self,
        params: dict,
        x: jax.Array,
        key: jax.Array,
        lrt: bool = True,
        per_example_noise: bool = False,
    ) -> jax.Array:
        """``(..., n_in) -> (..., n_out)``: pad, all blocks at once, truncate
        (reference forward, src/weights.py:182-208)."""
        _, _, _, stack = self.dims
        xp = self._pad(x)[..., None, :]  # (..., 1, D_in) -> bcast over stack
        s1, s2 = params["s1"], params["s2"]  # (stack, D_in)
        if lrt:
            shape = (
                x.shape[:-1] + params["g_mu"].shape
                if per_example_noise
                else params["g_mu"].shape
            )
            eps = jax.random.normal(key, shape, x.dtype)
            # W_bar is linear in u: one product == mean + noise products
            u = params["g_mu"] + _g_sigma(params["g_rho"]) * eps
            out = whvi_mul(s1, u, s2, xp)  # (..., stack, D_in)
        else:
            g = self.sample_g(params, key)
            out = whvi_mul(s1, g, s2, xp)
        out = out.reshape(out.shape[:-2] + (-1,))  # (..., D_out)
        return out[..., : self.n_out]

    def apply_given_g(
        self, params: dict, x: jax.Array, g: jax.Array
    ) -> jax.Array:
        """Deterministic forward with explicit ``g`` of shape
        ``(stack, D_in)`` (MCMC path)."""
        xp = self._pad(x)[..., None, :]
        out = whvi_mul(params["s1"], g, params["s2"], xp)
        out = out.reshape(out.shape[:-2] + (-1,))
        return out[..., : self.n_out]


@dataclasses.dataclass(frozen=True)
class ColumnMatrix:
    """``(n, 1)`` column (or ``(1, n)`` row when ``transposed``) matrix.

    Reference ``WHVIColumnMatrix`` (src/weights.py:211-251): a square
    ``D_adj x D_adj`` WHVI matrix with ``D_adj = next_pow_of_2(n)`` is
    sampled, flattened row-major, and its first ``n`` entries form the
    column. The reference materializes the full dense sample; here only the
    ``ceil(n / D_adj)`` rows that survive truncation are computed:
    ``row_i(W) = s1[i] * fwht(H[i, :] * g) * s2`` — O(n) work instead of
    O(D_adj^2), which is what makes D = 8192 column layers cheap.

    The reference always uses the explicit-sample path here (no LRT,
    weights.py:250-251); we match that.
    """

    n: int
    lambda_: float = 1e-5
    transposed: bool = False
    s_init: float | str = 0.01
    # opt-in per-example LRT (see apply); False = reference-faithful
    # explicit sample, keeping published results reproducible
    use_lrt: bool = False

    @property
    def D_adj(self) -> int:
        return next_pow_of_2(self.n)

    @property
    def n_in(self) -> int:
        return self.n if self.transposed else 1

    @property
    def n_out(self) -> int:
        return 1 if self.transposed else self.n

    @property
    def _block(self) -> SquarePow2Matrix:
        return SquarePow2Matrix(self.D_adj, self.lambda_, self.s_init)

    def init(self, key: jax.Array, dtype=jnp.float32) -> dict:
        return self._block.init(key, dtype)

    def kl(self, params: dict, lambda_=None) -> jax.Array:
        return self._block.kl(params, lambda_)

    def column_given_g(self, params: dict, g: jax.Array) -> jax.Array:
        """Column from an explicit ``g`` (MCMC path / LRT building
        block). ``g`` may carry leading batch axes ``(..., D_adj)`` —
        the column broadcasts to ``(..., n)`` (the per-example LRT path
        below feeds a per-row noise batch through here)."""
        D = self.D_adj
        n_rows = -(-self.n // D)
        # only the surviving rows of H — never the O(D^2) dense matrix
        H_rows = build_H_rows(D, n_rows, g.dtype)
        rows = (
            params["s1"][:n_rows, None]
            * fwht(H_rows * g[..., None, :])
            * params["s2"]
        )
        return rows.reshape(g.shape[:-1] + (n_rows * D,))[..., : self.n]

    def apply_given_g(
        self, params: dict, x: jax.Array, g: jax.Array
    ) -> jax.Array:
        col = self.column_given_g(params, g)
        if self.transposed:
            return jnp.sum(x * col, axis=-1, keepdims=True)
        return x * col

    def sample_column(self, params: dict, key: jax.Array) -> jax.Array:
        """First ``n`` entries of ``vec(W)`` (row-major), shape ``(n,)``."""
        g = self._block.sample_g(params, key)
        return self.column_given_g(params, g)

    def sample_W(self, params: dict, key: jax.Array) -> jax.Array:
        col = self.sample_column(params, key)
        return col[None, :] if self.transposed else col[:, None]

    def apply(
        self,
        params: dict,
        x: jax.Array,
        key: jax.Array,
        lrt: bool = False,
        per_example_noise: bool = False,
    ) -> jax.Array:
        """The reference always draws one explicit column sample here
        (no LRT, its weights.py:250-251) and so does our default. But
        the column is LINEAR in ``g`` — ``col(mu + sigma*eps) = col(mu)
        + col(sigma*eps)`` — so with per-example noise the LRT form is
        available for free: an independent eps per batch row makes the
        column layer a variance-reduced estimator instead of the
        highest-variance one in the net (one shared weight draw per
        batch; round-3 VERDICT weak #6 — the trade-off is measured in
        benchmarks/column_lrt_check.py). Engaged only when the matrix
        opts in (``use_lrt``) AND the call passes both ``lrt`` and
        ``per_example_noise``: with shared batch noise the LRT and
        explicit paths are identical in distribution, and the published
        tuned-recipe results were measured on the explicit path — an
        implicit switch would silently change them.
        """
        if self.use_lrt and lrt and per_example_noise:
            sigma = _g_sigma(params["g_rho"])
            eps = jax.random.normal(
                key, x.shape[:-1] + (self.D_adj,), x.dtype
            )
            col = self.column_given_g(
                params, params["g_mu"] + sigma * eps
            )  # (..., n): an independent column per batch row
        else:
            col = self.sample_column(params, key)
        if self.transposed:
            # (..., n) @ (n, 1) -> (..., 1)
            return jnp.sum(x * col, axis=-1, keepdims=True)
        # (..., 1) * (n,) -> (..., n)
        return x * col


@dataclasses.dataclass(frozen=True)
class PaddedSquareMatrix:
    """Arbitrary ``(n_in, n_out)`` map as ONE padded square WHVI block.

    Alternative to :class:`StackedMatrix` for very rectangular shapes:
    inputs are zero-padded to ``D = next_pow_of_2(max(n_in, n_out))``,
    one ``D x D`` square WHVI matrix is applied, outputs truncated to
    ``n_out``. For e.g. (6, 128) the stacked construction yields 16
    independent 8x8 blocks (no mixing across blocks; reference
    setup_dimensions semantics), while this uses a single 128x128
    transform with full mixing at the same O(D) parameter count —
    measurably higher capacity on the UCI first layers. No reference
    counterpart (capability extension).
    """

    n_in: int
    n_out: int
    lambda_: float = 1e-5
    s_init: float | str = 0.01

    @property
    def D(self) -> int:
        return next_pow_of_2(max(self.n_in, self.n_out))

    @property
    def _block(self) -> SquarePow2Matrix:
        return SquarePow2Matrix(self.D, self.lambda_, self.s_init)

    def init(self, key: jax.Array, dtype=jnp.float32) -> dict:
        return self._block.init(key, dtype)

    def kl(self, params: dict, lambda_=None) -> jax.Array:
        return self._block.kl(params, lambda_)

    def sample_g(self, params: dict, key: jax.Array) -> jax.Array:
        return self._block.sample_g(params, key)

    def sample_W(self, params: dict, key: jax.Array) -> jax.Array:
        W = self._block.sample_W(params, key)
        return W[: self.n_out, : self.n_in]

    def _pad(self, x: jax.Array) -> jax.Array:
        pad = self.D - self.n_in
        if pad == 0:
            return x
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])

    def apply(
        self,
        params: dict,
        x: jax.Array,
        key: jax.Array,
        lrt: bool = True,
        per_example_noise: bool = False,
    ) -> jax.Array:
        y = self._block.apply(
            params,
            self._pad(x),
            key,
            lrt=lrt,
            per_example_noise=per_example_noise,
        )
        return y[..., : self.n_out]

    def apply_given_g(
        self, params: dict, x: jax.Array, g: jax.Array
    ) -> jax.Array:
        y = self._block.apply_given_g(params, self._pad(x), g)
        return y[..., : self.n_out]
