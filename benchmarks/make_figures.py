"""Regenerate the committed report figures (docs/figures/*.png).

The reference ships compiled performance plots and fan-chart figures
(report/performance-testing.tex:28 fig.; benchmarks/walsh_plot.py:20-97
-> compute-performance-all.pdf; Toy example.ipynb quantile fans);
docs/REPORT.md was tables-only until round 5 (VERDICT item #7). Three
script-regenerated figures:

1. ``toy_fan.png`` — the paper's headline visual: posterior-predictive
   fan charts on the degree-8 toy polynomial, trained WITH and WITHOUT
   the KL term. The with-KL model must show in-between uncertainty in
   the data gap x in [0.6, 1.4]; the no-KL model collapses to a point
   estimate (reference Toy example.ipynb cells 19-24).
2. ``fwht_crossover.png`` — FWHT-vs-dense-matmul crossover (runs
   benchmarks/fwht_sweep.py's sweep in this process, the walsh_plot.py
   analogue; one process per card).
3. ``reliability.png`` — pooled nominal-vs-empirical coverage on the
   yacht protocol, raw vs temperature-calibrated (the round-4/5
   calibration machinery made visible).

Run: python benchmarks/make_figures.py [--cpu] [--quick] [--only NAME]
``--quick`` shrinks epochs for a fast smoke regeneration; committed
figures use the default (full) settings.

Colors: the dataviz-validated categorical order (slot1 blue #2a78d6,
slot2 orange #eb6834) on a white surface; text/grid in neutral ink.
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

import numpy as np

BLUE, ORANGE = "#2a78d6", "#eb6834"
INK, MUTED = "#222222", "#777777"
FIGDIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "docs",
    "figures",
)


def _style(ax):
    ax.grid(True, linewidth=0.3, alpha=0.35)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.tick_params(labelsize=8, colors=INK)


def fig_toy_fan(quick=False):
    import jax
    import jax.numpy as jnp
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from whvi_tpu.data import polynomial_data
    from whvi_tpu.models import WHVILinear, WHVIRegression, sigmoid
    from whvi_tpu.train import TrainConfig, Trainer

    X, y = polynomial_data(seed=0)
    epochs2 = 2000 if quick else 20000

    def fit(ignore_kl):
        net = WHVIRegression(
            [
                WHVILinear(1, 128, lambda_=1.0, s_init="auto"),
                sigmoid,
                WHVILinear(
                    128, 128, lambda_=2.5, s_init="auto",
                    per_example_noise=True,
                ),
                sigmoid,
                WHVILinear(128, 1, lambda_=5.0, s_init="auto"),
            ],
            sigma0=0.1,
            train_samples=4,
            eval_samples=128,
        )
        total = 500 + epochs2
        cfg = TrainConfig(
            batch_size=128,
            epochs1=500,
            epochs2=epochs2,
            ignore_kl=ignore_kl,
            kl_warmup_steps=int(total * 0.4),
            epochs_per_call=500,
        )
        tr = Trainer(net, cfg)
        state = tr.init(jax.random.PRNGKey(0))
        state, _ = tr.fit(state, X, y)
        return net, state.params

    xs = np.linspace(-1.15, 1.95, 240, dtype=np.float32)[:, None]
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6), sharey=True)
    for ax, ignore_kl, title in (
        (axes[0], False, "ELBO (with KL)"),
        (axes[1], True, "no-KL ablation"),
    ):
        net, params = fit(ignore_kl)
        y_hat = net.predict(
            params, jnp.asarray(xs), jax.random.PRNGKey(7), 128
        )
        mean, sd = net.likelihood.predict(params["likelihood"], y_hat)
        mean = np.asarray(mean)[:, 0]
        sd = np.asarray(sd)[:, 0]
        x1 = xs[:, 0]
        # 50% / 95% central fans of the Gaussian predictive
        for z, alpha in ((1.96, 0.18), (0.674, 0.32)):
            ax.fill_between(
                x1, mean - z * sd, mean + z * sd,
                color=BLUE, alpha=alpha, linewidth=0,
            )
        ax.plot(x1, mean, color=BLUE, linewidth=2, label="predictive mean")
        ax.scatter(
            np.asarray(X)[:, 0], np.asarray(y)[:, 0],
            s=9, color=INK, alpha=0.55, linewidths=0, label="train data",
            zorder=3,
        )
        ax.axvspan(0.6, 1.4, color=MUTED, alpha=0.08, zorder=0)
        ax.set_title(title, fontsize=10, color=INK)
        ax.set_xlabel("x", fontsize=9, color=INK)
        _style(ax)
    axes[0].set_ylabel("y", fontsize=9, color=INK)
    axes[0].legend(
        fontsize=8, loc="upper left", frameon=True, framealpha=0.85,
        edgecolor="none",
    )
    axes[0].annotate(
        "data gap", (1.0, axes[0].get_ylim()[0]),
        ha="center", va="bottom", fontsize=8, color=MUTED,
    )
    fig.suptitle(
        "Toy polynomial: in-between uncertainty needs the KL term",
        fontsize=11, color=INK,
    )
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    out = os.path.join(FIGDIR, "toy_fan.png")
    fig.savefig(out, dpi=160)
    print(json.dumps({"figure": out}))


def fig_crossover(quick=False):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fwht_sweep import sweep

    out = os.path.join(FIGDIR, "fwht_crossover.png")
    if quick:
        sweep(512, 20, [64, 256, 1024], out)
    else:
        sweep(512, 100, [64, 128, 256, 512, 1024, 2048, 4096], out)
    print(json.dumps({"figure": out}))


def fig_reliability(quick=False):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from whvi_tpu.data.uci import load_uci
    from whvi_tpu.evaluation import (
        ProtocolConfig,
        evaluate_bayesian_regression,
    )

    X, y = load_uci("yacht")
    cfg = ProtocolConfig(
        n_splits=4 if quick else 8,
        epochs1=100 if quick else 500,
        epochs2=2000 if quick else 50000,
        bias=True,
        per_example_noise=True,
        train_samples=8,
        sigma0=0.1,
        calibrate=True,
        calib_frac=0.15,
        calib_pooled=True,
        checkpoint_every=0,
    )
    out_res = evaluate_bayesian_regression(X, y, cfg)
    fig, ax = plt.subplots(figsize=(4.6, 4.2))
    ax.plot([0, 1], [0, 1], color=MUTED, linewidth=0.8, linestyle="--",
            label="perfect calibration")
    for key, color, label in (
        ("reliability_raw", ORANGE, "raw predictive"),
        ("reliability_cal", BLUE, "temperature-calibrated"),
    ):
        tab = out_res[key]
        ax.plot(
            [r["nominal"] for r in tab],
            [r["empirical"] for r in tab],
            color=color, linewidth=2, marker="o", markersize=4,
            label=label,
        )
    tau = out_res["temperature_mean"]
    ax.set_xlabel("nominal central-interval level", fontsize=9, color=INK)
    ax.set_ylabel("empirical coverage (pooled test z)", fontsize=9,
                  color=INK)
    ax.set_title(
        f"Yacht protocol reliability (pooled tau = {tau:.2f})",
        fontsize=10, color=INK,
    )
    ax.legend(frameon=False, fontsize=8, loc="upper left")
    _style(ax)
    fig.tight_layout()
    out = os.path.join(FIGDIR, "reliability.png")
    fig.savefig(out, dpi=160)
    print(json.dumps({"figure": out, "temperature_mean": tau}))


def fig_sampler_rescue(quick=False):
    """ESS on the over-trained mixed-lambda posterior, per sampler —
    read from the committed docs/vi_vs_hmc.json (no recompute; pass
    the study's --out elsewhere to re-measure)."""
    del quick
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(
        os.path.join(os.path.dirname(FIGDIR), "vi_vs_hmc.json")
    ) as f:
        study = json.load(f)
    row = study["mixed_lambda"]["epochs_12000"]
    pt = row["tempering"]
    sc = pt["ess_scaling"]
    rows = [
        ("NUTS, identity mass", row["identity_mass"]["ess_min_overall"]),
        ("NUTS, adapted diagonal", row["adapted_mass"]["ess_min_overall"]),
        (
            f"PT 16-rung, {sc['draws_quarter']} rounds",
            sc["ess_quarter"],
        ),
        (f"PT 16-rung, {sc['draws_full']} rounds", sc["ess_full"]),
    ]
    fig, ax = plt.subplots(figsize=(6.4, 3.2))
    ys = range(len(rows))
    for y, (label, ess) in zip(ys, rows):
        color = BLUE if label.startswith("PT") else ORANGE
        ax.plot([0.8, ess], [y, y], color=color, linewidth=1.2,
                alpha=0.5, zorder=1)
        ax.plot([ess], [y], "o", color=color, markersize=8, zorder=2)
        ax.annotate(
            f"{ess:.0f}" if ess >= 10 else f"{ess:.1f}",
            (ess, y), xytext=(8, -3), textcoords="offset points",
            fontsize=9, color=INK,
        )
    ax.axvline(100, color=MUTED, linewidth=0.8, linestyle="--", zorder=0)
    ax.annotate("healthy (ESS 100)", (100, -0.45),
                xytext=(5, 0), textcoords="offset points", fontsize=8,
                color=MUTED, annotation_clip=False)
    ax.set_yticks(list(ys))
    ax.set_yticklabels([r[0] for r in rows], fontsize=9)
    ax.set_xscale("log")
    ax.set_xlim(0.8, 2000)
    ax.set_xlabel(
        "min effective sample size (log scale)", fontsize=9, color=INK
    )
    ax.set_title(
        "Over-trained mixed-λ posterior: tempering un-freezes the "
        "sampler",
        fontsize=10, color=INK,
    )
    _style(ax)
    ax.grid(axis="y", visible=False)
    fig.tight_layout()
    out = os.path.join(FIGDIR, "sampler_rescue.png")
    fig.savefig(out, dpi=160)
    print(json.dumps({"figure": out}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--only",
        choices=["toy_fan", "crossover", "reliability", "sampler_rescue"],
        default=None,
    )
    args = ap.parse_args()
    os.makedirs(FIGDIR, exist_ok=True)
    if args.only in (None, "toy_fan"):
        fig_toy_fan(args.quick)
    if args.only in (None, "crossover"):
        fig_crossover(args.quick)
    if args.only in (None, "reliability"):
        fig_reliability(args.quick)
    if args.only in (None, "sampler_rescue"):
        fig_sampler_rescue(args.quick)


if __name__ == "__main__":
    main()
