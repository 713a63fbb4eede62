"""Networks: sequential WHVI models with vmapped MC-ELBO estimation.

Counterpart of reference ``WHVINetwork`` / ``WHVIRegression``
(src/networks.py:12-133), functional:

- ``init(key) -> params`` builds the parameter pytree
  ``{"layers": (p0, p1, ...), "likelihood": {...}}``;
- one forward pass is one MC sample; ``predict`` draws ``S`` samples via
  ``jax.vmap`` over split PRNG keys — replacing the reference's Python
  loop over samples (networks.py:47-51), which is the first thing that
  must go on an accelerator (each loop iteration would be a separate
  dispatch; vmap batches the samples into the matmuls);
- ``loss`` is the negative ELBO: total-dataset MNLL estimate + summed KL
  (reference networks.py:56-69), with ``ignore_kl`` matching the
  reference's ablation switch.

The training loop lives in ``whvi_tpu.train`` (the reference fuses it into
the network class; here it is a jitted pure function over (params,
opt_state)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp

__all__ = [
    "WHVINetwork",
    "WHVIRegression",
    "WHVIClassification",
    "mlp_layers",
]


@dataclasses.dataclass(frozen=True)
class WHVINetwork:
    """A sequential model over WHVI / deterministic layers + a likelihood.

    ``train_samples`` / ``eval_samples`` are the default MC sample counts
    (reference defaults 1 / 64, networks.py:12-27).
    """

    layers: Sequence[Any]
    likelihood: Any
    train_samples: int = 1
    eval_samples: int = 64

    def init(self, key: jax.Array, dtype=jnp.float32) -> dict:
        keys = jax.random.split(key, len(self.layers))
        return {
            "layers": tuple(
                layer.init(k, dtype) for layer, k in zip(self.layers, keys)
            ),
            "likelihood": self.likelihood.init(dtype),
        }

    def kl(self, params: dict, lambdas=None) -> jax.Array:
        """Sum of per-layer KL terms (reference networks.py:32-34).

        ``lambdas``: optional per-layer prior-variance overrides — a
        tuple aligned with ``layers``, entries None (keep the layer's
        static lambda) or a traceable scalar (or per-branch tuple for
        Parallel heads). The config-stacked protocol sweeps priors per
        vmapped replica through this without rebuilding the model."""
        if lambdas is None:
            lambdas = (None,) * len(self.layers)
        if len(lambdas) != len(self.layers):
            # zip would silently TRUNCATE — dropping trailing layers'
            # KL from the ELBO with no error (round-5 review)
            raise ValueError(
                f"lambdas must have one entry per layer "
                f"({len(self.layers)}), got {len(lambdas)}"
            )
        return sum(
            layer.kl(p, lam)
            for layer, p, lam in zip(self.layers, params["layers"], lambdas)
        )

    def apply(self, params: dict, x: jax.Array, key: jax.Array) -> jax.Array:
        """One stochastic forward pass (one MC sample).

        Each layer gets its own fold of the key — one independent epsilon
        per (layer, call), same granularity as the reference (one eps per
        forward per block, weights.py:92) but with explicit, reproducible
        keys.
        """
        keys = jax.random.split(key, len(self.layers))
        for layer, p, k in zip(self.layers, params["layers"], keys):
            x = layer.apply(p, x, k)
        return x

    def predict(
        self, params: dict, x: jax.Array, key: jax.Array, n_samples: int
    ) -> jax.Array:
        """``(S, B, n_out)`` stacked MC predictions via vmap over keys."""
        keys = jax.random.split(key, n_samples)
        return jax.vmap(lambda k: self.apply(params, x, k))(keys)

    def loss(
        self,
        params: dict,
        key: jax.Array,
        x: jax.Array,
        y: jax.Array,
        n: jax.Array | int,
        n_samples: int | None = None,
        ignore_kl: bool = False,
        kl_scale: jax.Array | float = 1.0,
        weights: jax.Array | None = None,
        lambdas=None,
    ) -> tuple[jax.Array, dict]:
        """Negative ELBO = MNLL + kl_scale * KL (reference networks.py:56-69).

        ``ignore_kl`` matches the reference's ablation switch;
        ``kl_scale`` is a (traceable) annealing factor — ramping it from
        0 to 1 early in training prevents the posterior-collapse local
        optimum where KL hits 0 before the likelihood term has shaped the
        mean function (observed with the reference's own init scale; see
        train/trainer.py kl_warmup_steps).

        Returns ``(loss, aux)`` with ``aux = {"mnll": ..., "kl": ...}``
        (the reference caches these as ``current_mnll``/``current_kl`` for
        its progress bar, networks.py:29-30). Optional ``weights (B,)``
        de-bias statically padded batches (0 = padding row; see
        likelihoods._weighted_total).
        """
        S = self.train_samples if n_samples is None else n_samples
        y_hat = self.predict(params, x, key, S)
        mnll = self.likelihood.mnll(
            params["likelihood"], y, y_hat, n, weights=weights
        )
        kl = self.kl(params, lambdas)
        loss = mnll if ignore_kl else mnll + kl_scale * kl
        return loss, {"mnll": mnll, "kl": kl}

    def eval_metrics(
        self,
        params: dict,
        key: jax.Array,
        x: jax.Array,
        y: jax.Array,
        n_samples: int | None = None,
    ) -> dict:
        """Test-set metrics: total MNLL (reference eval_model,
        networks.py:101-115), per-point MNLL, and RMSE of the MC-mean
        prediction (reference WHVIRegression.eval_model,
        networks.py:130-133)."""
        S = self.eval_samples if n_samples is None else n_samples
        y_hat = self.predict(params, x, key, S)
        return self.metrics_from_predictions(params, y, y_hat)

    def metrics_from_predictions(
        self, params: dict, y: jax.Array, y_hat: jax.Array
    ) -> dict:
        """The eval metrics given already-drawn MC predictions ``y_hat
        (S, B, n_out)`` — shared by the single-device path above and the
        mesh-sharded eval path (train.Trainer routes prediction through
        ``parallel.make_sharded_predict`` when it holds a mesh, so the
        64-sample eval is SPMD like training)."""
        S = y_hat.shape[0]
        n = y.shape[0]
        mnll = self.likelihood.mnll(params["likelihood"], y, y_hat, n)
        out = {"mnll": mnll, "mnll_per_point": mnll / n}
        if hasattr(self.likelihood, "log_prob"):
            # Posterior-predictive MNLL (the original paper's UCI metric):
            # -mean_i log (1/S) sum_s p(y_i | f_s). The reference only has
            # the mean-of-log estimator above (its likelihoods.py:18-29),
            # which upper-bounds this by Jensen.
            lp = self.likelihood.log_prob(params["likelihood"], y, y_hat)
            pred_ll = jax.scipy.special.logsumexp(lp, axis=0) - jnp.log(S)
            out["pred_mnll_per_point"] = -jnp.mean(pred_ll)
        if y.ndim > 1 and y_hat.ndim == 3 and y_hat.shape[-1] == y.shape[-1]:
            rmse = jnp.sqrt(
                jnp.mean(jnp.square(jnp.mean(y_hat, axis=0) - y))
            )
            out["rmse"] = rmse
        if hasattr(self.likelihood, "predict"):
            # 95% central-interval coverage (PICP) under the two-moment
            # Gaussian approximation of the posterior predictive
            # (likelihood.predict's mixture moments). Calibration
            # metric: well-calibrated ≈ 0.95; affine-invariant, so
            # normalized-target runs report it directly. Gaussian
            # likelihoods only (categorical predict returns probs).
            moments = self.likelihood.predict(params["likelihood"], y_hat)
            if isinstance(moments, tuple) and y.ndim == moments[0].ndim:
                mean, sd = moments
                inside = jnp.abs(y - mean) <= 1.9599640 * sd
                out["coverage95"] = jnp.mean(inside.astype(jnp.float32))
        return out


def mlp_layers(
    n_in: int,
    n_out: int,
    hidden: Sequence[int] = (128, 128),
    lambda_hidden: float = 3.0,
    lambda_last: float = 1e-5,
    activation=None,
    rect_mode: str = "stack",
    bias: bool = False,
) -> list:
    """The reference UCI architecture builder: WHVI MLP with ReLU hidden
    activations, prior variance ``lambda_hidden`` on hidden layers and
    ``lambda_last`` on the output layer (reference evaluation.py:79-85).
    ``rect_mode`` selects the non-square construction: "stack" =
    reference block-stacking semantics, "pad" = one padded square block
    with full input/output mixing (see weights.PaddedSquareMatrix).
    ``bias`` adds deterministic bias vectors (the reference supports but
    never enables them, layers.py:20; without biases a ReLU MLP is
    positively homogeneous — it is pinned to f(0) = 0 at the
    standardized-feature mean, which matters for raw-unit targets).
    """
    from whvi_tpu.models.layers import WHVILinear, relu

    act = activation if activation is not None else relu
    dims = [n_in, *hidden]
    layers: list = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers.append(
            WHVILinear(
                a, b, lambda_=lambda_hidden, rect_mode=rect_mode, bias=bias
            )
        )
        layers.append(act)
    layers.append(
        WHVILinear(
            dims[-1], n_out, lambda_=lambda_last, rect_mode=rect_mode,
            bias=bias,
        )
    )
    return layers


def WHVIClassification(
    layers,
    train_samples: int = 1,
    eval_samples: int = 16,
) -> WHVINetwork:
    """Convenience constructor: network + categorical (softmax)
    likelihood over logits — the Bayesian-classifier configuration
    (BASELINE.json MNIST config); no reference counterpart."""
    from whvi_tpu.models.likelihoods import CategoricalLikelihood

    return WHVINetwork(
        layers=tuple(layers),
        likelihood=CategoricalLikelihood(),
        train_samples=train_samples,
        eval_samples=eval_samples,
    )


def WHVIRegression(
    layers: Sequence[Any],
    sigma0: float = 1.0,
    train_samples: int = 1,
    eval_samples: int = 64,
) -> WHVINetwork:
    """Convenience constructor: network + Gaussian likelihood with initial
    noise stddev ``sigma0`` (reference WHVIRegression, networks.py:118-133).
    """
    from whvi_tpu.models.likelihoods import GaussianLikelihood

    return WHVINetwork(
        layers=tuple(layers),
        likelihood=GaussianLikelihood(sigma0),
        train_samples=train_samples,
        eval_samples=eval_samples,
    )
