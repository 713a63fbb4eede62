"""Toy cubic regression — the reference README quickstart end-to-end.

Reference protocol (README.md:25-53): 200 points of
``y = x0 + x1^2 - 0.3 x2^3``, 150/50 split, model
``[WHVILinear(3,16,lambda=2), ReLU, WHVILinear(16,1)]``, Adam 1e-3 with
``(1+5e-4 t)^-0.3`` decay, 500 fixed-likelihood + 1500 full epochs,
reporting test RMSE and MNLL.

Run: ``python experiments/run_toy_cubic.py [--epochs2 1500]``
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

from whvi_tpu.data import cubic_data
from whvi_tpu.models import WHVILinear, WHVIRegression, relu
from whvi_tpu.train import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs1", type=int, default=500)
    ap.add_argument("--epochs2", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument(
        "--s-init",
        default="auto",
        help="'auto' (variance-preserving, default) or a float stddev "
        "(0.01 = reference weights.py:29-30)",
    )
    ap.add_argument(
        "--kl-warmup-frac",
        type=float,
        default=0.5,
        help="fraction of total batch steps over which the KL weight "
        "ramps 0->1 (prevents posterior collapse)",
    )
    args = ap.parse_args()
    s_init = args.s_init if args.s_init == "auto" else float(args.s_init)

    (X_tr, y_tr), (X_te, y_te) = cubic_data(seed=args.seed)
    net = WHVIRegression(
        [
            WHVILinear(3, 16, lambda_=2.0, s_init=s_init),
            relu,
            WHVILinear(16, 1, s_init=s_init),
        ],
        eval_samples=64,
    )
    total = args.epochs1 + args.epochs2
    batches_per_epoch = -(-150 // 64)
    cfg = TrainConfig(
        epochs1=args.epochs1,
        epochs2=args.epochs2,
        kl_warmup_steps=int(total * batches_per_epoch * args.kl_warmup_frac),
    )
    trainer = Trainer(net, cfg)
    state = trainer.init(jax.random.PRNGKey(args.seed))

    t0 = time.time()
    state, logs = trainer.fit(
        state,
        X_tr,
        y_tr,
        ckpt_dir=args.ckpt_dir,
        log_fn=lambda e: print(json.dumps(e), flush=True),
    )
    wall = time.time() - t0
    metrics = trainer.evaluate(state.params, X_te, y_te, jax.random.PRNGKey(1))
    total_epochs = args.epochs1 + args.epochs2
    print(
        json.dumps(
            {
                "experiment": "toy_cubic",
                "rmse": metrics["rmse"],
                "mnll": metrics["mnll"],
                "mnll_per_point": metrics["mnll_per_point"],
                "pred_mnll_per_point": metrics.get("pred_mnll_per_point"),
                "wall_s": wall,
                "epochs_per_s": total_epochs / wall,
            }
        )
    )


if __name__ == "__main__":
    from whvi_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
