"""Bayesian MNIST classifier with WHVI layers + HMC moment validation.

BASELINE.json config: "MNIST Bayesian classifier with WHVILinear D=1024
+ softmax likelihood; HMC golden run on a frozen subset to validate VI
moments". Architecture: 784 -> 1024 (WHVI) -> ReLU -> 1024 (WHVI,
square pow-2) -> ReLU -> 1024 -> 10 (WHVI stacked), categorical
likelihood, two-phase ELBO training, test accuracy + MNLL.

Falls back to structured synthetic classification data when the MNIST
IDX files are absent (zero-egress environments); pass --require-mnist
to fail instead.

The optional --hmc pass freezes the trained model, builds the exact
g-posterior on a data subset and compares HMC posterior moments of the
last layer's g against the variational (g_mu, softplus(g_rho)).
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
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from whvi_tpu.data.mnist import (
    load_mnist,
    mnist_available,
    synthetic_classification,
)
from whvi_tpu.models import (
    CategoricalLikelihood,
    WHVILinear,
    WHVINetwork,
    relu,
)
from whvi_tpu.train import TrainConfig, Trainer


def accuracy(net, params, X, y, key, n_samples=16, batch=2048):
    pad = (-len(X)) % batch
    Xp = np.pad(X, ((0, pad), (0, 0)))

    @jax.jit
    def batch_probs(params, xb, key):
        return net.likelihood.predict(
            params["likelihood"], net.predict(params, xb, key, n_samples)
        )

    correct = 0
    for i in range(0, len(Xp), batch):
        probs = batch_probs(params, jnp.asarray(Xp[i : i + batch]), key)
        pred = np.asarray(jnp.argmax(probs, -1))
        yb = y[i : i + batch]
        correct += int(np.sum(pred[: len(yb)] == yb))
    return correct / len(X)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--epochs1", type=int, default=2)
    ap.add_argument("--epochs2", type=int, default=18)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--train-samples", type=int, default=1)
    ap.add_argument("--eval-samples", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--require-mnist", action="store_true")
    ap.add_argument(
        "--data",
        choices=[
            "auto", "mnist", "digits", "wine", "breast_cancer", "synthetic"
        ],
        default="auto",
        help="auto: MNIST IDX files if present, else the REAL sklearn "
        "digits set (8x8, 10 classes, bundled offline), else synthetic; "
        "wine/breast_cancer: other real sklearn-bundled sets",
    )
    ap.add_argument("--lambda-hidden", type=float, default=3.0)
    ap.add_argument("--lambda-last", type=float, default=1.0)
    ap.add_argument(
        "--bias",
        action="store_true",
        help="deterministic bias on every WHVI layer",
    )
    ap.add_argument(
        "--calibrate",
        action="store_true",
        help="hold 10%% of train out, fit a softmax logit temperature "
        "on it (whvi_tpu.calibration.fit_logit_temperature), report "
        "test NLL/ECE raw vs tempered",
    )
    ap.add_argument("--hmc", action="store_true", help="golden-sampler check")
    ap.add_argument("--subset", type=int, default=0, help="train subset size")
    args = ap.parse_args()

    from whvi_tpu.data.mnist import (
        load_digits_classification,
        load_sklearn_classification,
    )

    want = args.data
    if want == "auto":
        if mnist_available():
            want = "mnist"
        elif args.require_mnist:
            raise SystemExit("MNIST IDX files not found")
        else:
            want = "digits"  # real data beats synthetic
    if want == "mnist":
        (X_tr, y_tr), (X_te, y_te) = load_mnist()
        source = "mnist"
    elif want == "digits":
        (X_tr, y_tr), (X_te, y_te) = load_digits_classification(
            seed=args.seed
        )
        source = "digits"
    elif want in ("wine", "breast_cancer"):
        (X_tr, y_tr), (X_te, y_te) = load_sklearn_classification(
            want, seed=args.seed
        )
        source = want
    else:
        (X_tr, y_tr), (X_te, y_te) = synthetic_classification()
        source = "synthetic"
    if args.subset:
        X_tr, y_tr = X_tr[: args.subset], y_tr[: args.subset]

    W = args.width
    net = WHVINetwork(
        layers=(
            WHVILinear(
                X_tr.shape[1], W, lambda_=args.lambda_hidden,
                s_init="auto", bias=args.bias,
            ),
            relu,
            WHVILinear(
                W, W, lambda_=args.lambda_hidden, s_init="auto",
                bias=args.bias,
            ),
            relu,
            WHVILinear(
                W, int(y_tr.max()) + 1, lambda_=args.lambda_last,
                s_init="auto", bias=args.bias,
            ),
        ),
        likelihood=CategoricalLikelihood(),
        train_samples=args.train_samples,
        eval_samples=args.eval_samples,
    )
    # the calibration holdout must come out BEFORE the warmup math:
    # steps_per_epoch feeds kl_warmup_steps, and a post-config holdout
    # would stretch the warmup fraction past the configured 0.3
    # (round-4 review #4)
    X_cal = y_cal = None
    if args.calibrate:
        # seeded reshuffle first: the digits/wine loaders shuffle, but
        # the raw MNIST IDX path keeps file order, so a head-slice
        # holdout could be unrepresentative (round-4 advisor finding)
        perm = np.random.RandomState(args.seed).permutation(len(X_tr))
        X_tr, y_tr = X_tr[perm], y_tr[perm]
        n_cal = max(1, len(X_tr) // 10)
        X_cal, y_cal = X_tr[:n_cal], y_tr[:n_cal]
        X_tr, y_tr = X_tr[n_cal:], y_tr[n_cal:]

    total = args.epochs1 + args.epochs2
    steps_per_epoch = -(-len(X_tr) // args.batch)
    cfg = TrainConfig(
        batch_size=args.batch,
        epochs1=args.epochs1,
        epochs2=args.epochs2,
        epochs_per_call=max(1, total // 10),
        kl_warmup_steps=int(0.3 * total * steps_per_epoch),
    )
    trainer = Trainer(net, cfg)
    state = trainer.init(jax.random.PRNGKey(args.seed))

    t0 = time.time()
    state, logs = trainer.fit(
        state,
        X_tr,
        y_tr.astype(np.int32),
        log_fn=lambda e: print(json.dumps(e), flush=True),
    )
    wall = time.time() - t0

    acc = accuracy(net, state.params, X_te, y_te, jax.random.PRNGKey(1))
    out = {
        "experiment": "mnist",
        "source": source,
        "width": W,
        "test_accuracy": acc,
        "wall_s": round(wall, 1),
        "epochs_per_s": round(total / max(wall, 1e-9), 2),
    }

    if args.calibrate:
        from whvi_tpu.calibration import (
            expected_calibration_error,
            fit_logit_temperature,
            tempered_mc_probs,
        )

        logits_fn = jax.jit(
            lambda p, x, k: net.predict(p, x, k, args.eval_samples)
        )
        cal_logits = np.asarray(
            logits_fn(state.params, jnp.asarray(X_cal), jax.random.PRNGKey(3))
        )
        te_logits = np.asarray(
            logits_fn(state.params, jnp.asarray(X_te), jax.random.PRNGKey(4))
        )
        fit = fit_logit_temperature(cal_logits, y_cal, return_info=True)
        tau = fit["tau"]
        probs = tempered_mc_probs  # the SAME mixture the fit used

        def nll(p):
            return float(
                -np.mean(
                    np.log(p[np.arange(len(y_te)), y_te.astype(int)] + 1e-12)
                )
            )

        p_raw, p_cal = probs(te_logits, 1.0), probs(te_logits, tau)
        out["logit_temperature"] = round(tau, 3)
        out["tau_at_edge"] = bool(fit["tau_at_edge"])
        if fit["tau_at_edge"]:
            out["logit_temperature_raw"] = round(fit["tau_raw"], 3)
        out["test_nll_raw"] = round(nll(p_raw), 4)
        out["test_nll_cal"] = round(nll(p_cal), 4)
        out["test_ece_raw"] = round(
            expected_calibration_error(p_raw, y_te), 4
        )
        out["test_ece_cal"] = round(
            expected_calibration_error(p_cal, y_te), 4
        )

    if args.hmc:
        # Golden-sampler check, round-2 scope (VERDICT item 3/4): the
        # sampler must PASS convergence gates before any VI comparison is
        # meaningful, and the comparison criterion is stated: VI sd is
        # EXPECTED to sit below the NUTS marginal sd by the mean-field
        # deficit (quantified exactly in experiments/run_vi_vs_hmc.py's
        # analytic tier); the VI mean should correlate with the NUTS mean.
        from whvi_tpu.mcmc import (
            NUTSConfig,
            ess,
            make_whvi_g_log_posterior,
            nuts_sample_chains,
            split_rhat,
        )

        Xs, ys = X_tr[:256], y_tr[:256]
        logp, init = make_whvi_g_log_posterior(net, state.params, Xs, ys)
        samples, stats = nuts_sample_chains(
            logp,
            init,
            jax.random.PRNGKey(2),
            NUTSConfig(n_samples=500, n_warmup=400, max_tree_depth=6),
            n_chains=4,
        )
        last = max(init.keys())
        gs = samples[last]
        rhat = float(jnp.max(split_rhat(gs)))
        n_eff = float(jnp.min(ess(gs)))
        divs = int(jnp.sum(stats["divergences"]))
        vi_mu = jnp.ravel(state.params["layers"][last]["g_mu"])
        vi_sd = jax.nn.softplus(
            jnp.ravel(state.params["layers"][last]["g_rho"])
        )
        hmc_mu = jnp.ravel(jnp.mean(gs, axis=(0, 1)))
        hmc_sd = jnp.ravel(jnp.std(gs, axis=(0, 1)))
        mu_corr = float(jnp.corrcoef(hmc_mu, vi_mu)[0, 1])
        converged = rhat < 1.05 and n_eff > 100 and divs == 0
        out["hmc"] = {
            "sampler": "nuts-4chain",
            "rhat_max": rhat,
            "ess_min": n_eff,
            "divergences": divs,
            "converged": converged,
            "mu_corr_vi_hmc": mu_corr,
            "hmc_sd_mean": float(jnp.mean(hmc_sd)),
            "vi_sd_mean": float(jnp.mean(vi_sd)),
            "sd_ratio_vi_over_hmc": float(
                jnp.mean(vi_sd / (hmc_sd + 1e-12))
            ),
            "criterion": "valid only if converged; expect sd_ratio < 1 "
            "(mean-field deficit, see run_vi_vs_hmc.py) and mu_corr "
            "well above 0",
        }
    print(json.dumps(out))


if __name__ == "__main__":
    from whvi_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
