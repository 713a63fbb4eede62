"""UCI regression experiments — the reference's per-dataset runners.

One CLI covering run_boston / run_concrete / run_energy / run_yacht /
run_kin8nm / run_naval (+ protein), with the reference's protocol
defaults (8 x 90/10 splits, 128-128 ReLU WHVI MLP, 500+50000 epochs,
evaluation.py:30-108).

Examples:
  python experiments/run_uci.py yacht
  python experiments/run_uci.py concrete --epochs2 2000 --splits 2
  python experiments/run_uci.py --list
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

from whvi_tpu.data.uci import UCI_DATASETS, dataset_info, load_uci
from whvi_tpu.evaluation import ProtocolConfig, evaluate_bayesian_regression


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", choices=sorted(UCI_DATASETS))
    ap.add_argument("--list", action="store_true", help="show availability")
    ap.add_argument("--splits", type=int, default=8)
    ap.add_argument("--epochs1", type=int, default=500)
    ap.add_argument("--epochs2", type=int, default=50000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--s-init", default="auto")
    ap.add_argument("--kl-warmup-frac", type=float, default=0.2)
    ap.add_argument(
        "--heteroscedastic",
        action="store_true",
        help="input-dependent noise head (BASELINE protein/kin8nm config)",
    )
    ap.add_argument("--normalize-y", action="store_true")
    ap.add_argument(
        "--lambda-hidden",
        type=float,
        default=3.0,
        help="prior variance of the hidden WHVI layers (protocol 3.0; "
        "the round-5 yacht grid found 1.0 marginally better)",
    )
    ap.add_argument(
        "--lambda-last",
        type=float,
        default=1e-5,
        help="prior scale of the mean output head (protocol 1e-5)",
    )
    ap.add_argument(
        "--lambda-noise",
        type=float,
        default=1.0,
        help="prior scale of the heteroscedastic noise branch — the "
        "head is a split-prior Parallel pair; a shared 1e-5 head pins "
        "sigma(x) to constant (docs/RESULTS.md round 3)",
    )
    ap.add_argument(
        "--noise-freeze-frac",
        type=float,
        default=0.5,
        help="fraction of training with the noise branch frozen at its "
        "sigma0 init (mean-first curriculum; heteroscedastic only)",
    )
    ap.add_argument("--sigma0", type=float, default=1.0)
    ap.add_argument("--hidden", type=int, nargs="*", default=[128, 128])
    ap.add_argument("--train-samples", type=int, default=1)
    ap.add_argument("--per-example-noise", action="store_true")
    ap.add_argument(
        "--column-lrt",
        action="store_true",
        help="per-example LRT on column-shaped heads (variance-reduced; "
        "needs --per-example-noise; see weights.ColumnMatrix.apply)",
    )
    ap.add_argument(
        "--rect-mode",
        choices=["stack", "pad"],
        default="stack",
        help="non-square layer construction (pad = full-mixing block)",
    )
    ap.add_argument(
        "--bias",
        action="store_true",
        help="deterministic bias on every WHVI layer (reference supports "
        "but never enables; lifts the f(0)=0 homogeneity constraint)",
    )
    ap.add_argument(
        "--ignore-kl",
        action="store_true",
        help="drop the KL term (MAP-with-noise capacity probe; reference "
        "loss(..., ignore_kl) switch)",
    )
    ap.add_argument(
        "--reference-exact",
        action="store_true",
        help="the reference's exact protocol settings (evaluation.py:15-47"
        " + weights.py:29-32): s_init=0.01, no KL warmup, sigma0=1, "
        "stacked non-square layers, 1 train MC sample, shared batch "
        "noise, no bias, X standardized on the FULL dataset. Overrides "
        "the corresponding flags; for the faithful-protocol rows "
        "published next to tuned ones",
    )
    ap.add_argument(
        "--calibrate",
        action="store_true",
        help="hold --calib-frac of each train split out, fit a scalar "
        "predictive-variance temperature on it, report tempered "
        "coverage (coverage95_cal) + pooled reliability tables",
    )
    ap.add_argument("--calib-frac", type=float, default=0.1)
    ap.add_argument(
        "--calib-mode",
        choices=["quantile", "nll"],
        default="quantile",
        help="temperature fit: coverage-matched quantile (default) or "
        "Gaussian-ML (density-oriented)",
    )
    ap.add_argument(
        "--calib-pooled",
        action="store_true",
        help="fit ONE temperature on all splits' pooled calib z-scores "
        "(8x the data for one scalar; cuts the order-statistic "
        "variance on small datasets)",
    )
    ap.add_argument(
        "--grid",
        default=None,
        help="JSON list of config-override dicts — run the whole sweep "
        "as ONE stacked protocol fit (n_configs x n_splits replicas in "
        "one compiled program; evaluate_config_grid). Keys: sigma0, "
        "lambda_hidden, lambda_last, lambda_noise, kl_warmup_frac, "
        "noise_freeze_frac, seed. Example: --grid "
        "'[{}, {\"lambda_noise\": 0.1}, {\"noise_freeze_frac\": 0}]'",
    )
    ap.add_argument(
        "--sequential-splits",
        action="store_true",
        help="train splits in the legacy sequential loop instead of the "
        "default single vmapped fit over all splits (same results; "
        "vmapped is ~KX faster — round-4 protocol accelerator)",
    )
    ap.add_argument(
        "--prng",
        choices=["threefry", "rbg"],
        default="threefry",
        help="PRNG implementation; per-example noise makes random bit "
        "generation a large share of the step, so the generator "
        "matters for speed (not yet measured on the GPU). Different "
        "random streams than threefry — results shift within "
        "split-to-split noise",
    )
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args()
    if args.prng == "rbg":
        import jax as _jax

        _jax.config.update("jax_default_prng_impl", "rbg")

    if args.list or not args.dataset:
        for name in sorted(UCI_DATASETS):
            print(json.dumps(dataset_info(name)))
        return

    X, y = load_uci(args.dataset)
    if args.reference_exact:
        args.s_init = "0.01"
        args.kl_warmup_frac = 0.0
        args.sigma0 = 1.0
        args.rect_mode = "stack"
        args.train_samples = 1
        args.per_example_noise = False
        args.column_lrt = False
        args.bias = False
        args.normalize_y = False
        args.heteroscedastic = False
    cfg = ProtocolConfig(
        n_splits=args.splits,
        epochs1=args.epochs1,
        epochs2=args.epochs2,
        batch_size=args.batch,
        seed=args.seed,
        s_init=args.s_init if args.s_init == "auto" else float(args.s_init),
        kl_warmup_frac=args.kl_warmup_frac,
        lambda_hidden=args.lambda_hidden,
        lambda_last=args.lambda_last,
        lambda_noise=args.lambda_noise,
        noise_freeze_frac=args.noise_freeze_frac,
        heteroscedastic=args.heteroscedastic,
        normalize_y=args.normalize_y,
        sigma0=args.sigma0,
        hidden=tuple(args.hidden),
        train_samples=args.train_samples,
        per_example_noise=args.per_example_noise,
        column_lrt=args.column_lrt,
        rect_mode=args.rect_mode,
        bias=args.bias,
        ignore_kl=args.ignore_kl,
        vmap_splits=False if args.sequential_splits else "auto",
        calibrate=args.calibrate,
        calib_frac=args.calib_frac,
        calib_mode=args.calib_mode,
        calib_pooled=args.calib_pooled,
    )
    log_fn = None if args.quiet else lambda e: print(json.dumps(e), flush=True)
    if args.grid is not None:
        from whvi_tpu.evaluation import evaluate_config_grid

        overrides = json.loads(args.grid)
        out = evaluate_config_grid(
            X,
            y,
            cfg,
            overrides,
            ckpt_dir=args.ckpt_dir
            or os.path.join("checkpoints", args.dataset),
            log_fn=log_fn,
        )
        out["dataset"] = args.dataset
        for c in out["configs"]:
            c.pop("splits", None)
        print(json.dumps(out))
        return
    out = evaluate_bayesian_regression(
        X,
        y,
        cfg,
        ckpt_dir=args.ckpt_dir
        or os.path.join("checkpoints", args.dataset),
        log_fn=log_fn,
    )
    out["dataset"] = args.dataset
    print(json.dumps({k: v for k, v in out.items() if k != "splits"}))


if __name__ == "__main__":
    from whvi_tpu.utils import enable_compile_cache

    enable_compile_cache()
    main()
