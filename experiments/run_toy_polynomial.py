"""The paper's toy polynomial experiment (reference Toy example.ipynb).

Degree-8 polynomial target with a gap on x in [0.6, 1.4], noise
N(0, exp(-3)), 128 points; WHVI model [WHVILinear(1,128, lambda=1),
sigmoid, WHVILinear(128,128, lambda=2.5), sigmoid, WHVILinear(128,1,
lambda=5)] with sigma0=0.1 — the notebook's KL configuration (cell 19;
~1537 parameters, report/model-testing.tex:60). Note the *Bayesian*
model in the notebook uses sigmoid activations (cells 14/19); the
cosine variant is its non-Bayesian comparison — and a bias-free
first-layer cosine makes every feature an even function of x, which
cannot fit this target (measured; use --activation cosine to see).
Reports train RMSE/MNLL and the predictive uncertainty inside vs
outside the gap (the paper's in-between-uncertainty claim: a Bayesian
model should be MORE uncertain in the gap).
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

from whvi_tpu.data import polynomial_data
from whvi_tpu.models import WHVILinear, WHVIRegression, cosine, sigmoid
from whvi_tpu.train import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs1", type=int, default=500)
    ap.add_argument("--epochs2", type=int, default=20000)
    ap.add_argument("--lambdas", type=float, nargs=3, default=[1.0, 2.5, 5.0])
    ap.add_argument("--sigma0", type=float, default=0.1)
    ap.add_argument("--activation", choices=["sigmoid", "cosine"], default="sigmoid")
    ap.add_argument("--s-init", default="auto")
    ap.add_argument("--train-samples", type=int, default=4)
    ap.add_argument("--ignore-kl", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    act = sigmoid if args.activation == "sigmoid" else cosine
    s_init = args.s_init if args.s_init == "auto" else float(args.s_init)
    l1, l2, l3 = args.lambdas

    X, y = polynomial_data(seed=args.seed)
    net = WHVIRegression(
        [
            WHVILinear(1, 128, lambda_=l1, s_init=s_init),
            act,
            WHVILinear(128, 128, lambda_=l2, s_init=s_init,
                       per_example_noise=True),
            act,
            WHVILinear(128, 1, lambda_=l3, s_init=s_init),
        ],
        sigma0=args.sigma0,
        train_samples=args.train_samples,
        eval_samples=64,
    )
    total = args.epochs1 + args.epochs2
    cfg = TrainConfig(
        batch_size=128,  # full-batch like the reference notebook (cell 3)
        epochs1=args.epochs1,
        epochs2=args.epochs2,
        ignore_kl=args.ignore_kl,
        kl_warmup_steps=int(total * 0.4),
        epochs_per_call=500,
    )
    trainer = Trainer(net, cfg)
    state = trainer.init(jax.random.PRNGKey(args.seed))
    t0 = time.time()
    state, logs = trainer.fit(state, X, y)
    wall = time.time() - t0

    m = trainer.evaluate(state.params, X, y, jax.random.PRNGKey(1))

    # in-between uncertainty: predictive stddev inside the gap vs on the
    # observed support
    xs_gap = np.linspace(0.7, 1.3, 50, dtype=np.float32).reshape(-1, 1)
    xs_obs = np.linspace(-0.9, 0.5, 50, dtype=np.float32).reshape(-1, 1)
    key = jax.random.PRNGKey(2)

    def pred_sd(xs):
        y_hat = net.predict(state.params, jnp.asarray(xs), key, 64)
        _, sd = net.likelihood.predict(state.params["likelihood"], y_hat)
        return float(jnp.mean(sd))

    out = {
        "experiment": "toy_polynomial",
        "ignore_kl": args.ignore_kl,
        "train_rmse": m["rmse"],
        "train_mnll_per_point": m["mnll_per_point"],
        "pred_sd_gap": pred_sd(xs_gap),
        "pred_sd_observed": pred_sd(xs_obs),
        "n_params": int(
            sum(
                int(np.prod(np.shape(l)))
                for l in jax.tree.leaves(state.params)
            )
        ),
        "wall_s": round(wall, 1),
        "epochs_per_s": round(total / max(wall, 1e-9), 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    from whvi_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
