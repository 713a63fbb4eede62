"""FWHT implementations vs dense matmul across D — the reference's
crossover study (benchmarks/walsh.py, walsh_plot.py: 1000 transforms x
batch 512, D = 2^6..2^11; its finding: vectorized CPU FWHT beats the
dense matmul from D ~ 2^11, report/performance-testing.tex:16-17).

Times the butterfly FWHT, the Kronecker-factor FWHT, and the dense-H
matmul on the current backend with difference-timed on-device chains,
and reports the measured crossover.

Run: python benchmarks/fwht_sweep.py [--cpu] [--batch 512]
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

import jax
import jax.numpy as jnp

from whvi_tpu.ops import build_H, fwht_butterfly, fwht_kron
from whvi_tpu.utils.profiling import chain_time


def _write_plot(rows, crossover, path, backend):
    """Log-log per-transform time vs D — counterpart of the reference's
    walsh_plot.py figure (compute-performance-all.pdf in its report)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # palette slots 1/2 — keep in sync with benchmarks/make_figures.py
    # BLUE/ORANGE so the four report figures read as one system
    series = [
        ("matmul_us", f"dense H matmul ({backend})", "#888888", "--"),
        ("butterfly_us", "FWHT butterfly", "#2a78d6", "-"),
        ("kron_us", "FWHT Kronecker factors", "#eb6834", "-"),
    ]
    fig, ax = plt.subplots(figsize=(6, 4))
    for key, label, color, ls in series:
        # difference timing can read <= 0 at tiny D (latency noise
        # exceeds the compute delta); a log axis cannot show those —
        # mask them instead of plunging to the clip edge
        pts = [(r["D"], r[key]) for r in rows if r[key] > 0]
        ax.plot([p[0] for p in pts], [p[1] for p in pts], label=label,
                color=color, linestyle=ls, marker="o", markersize=3.5)
    if crossover is not None:
        ax.axvline(crossover, color="#999999", linewidth=0.8, zorder=0)
        ax.annotate(f"crossover D={crossover}", (crossover, ax.get_ylim()[1]),
                    xytext=(4, -12), textcoords="offset points", fontsize=8,
                    color="#555555")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("transform size D")
    ax.set_ylabel("time per transform (µs)")
    ax.set_title(f"FWHT vs dense matmul, batch chains ({backend})")
    ax.legend(frameon=False, fontsize=8)
    ax.grid(True, which="both", linewidth=0.3, alpha=0.4)
    fig.tight_layout()
    fig.savefig(path)
    print(json.dumps({"plot": path}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument(
        "--sizes",
        type=int,
        nargs="*",
        default=[64, 128, 256, 512, 1024, 2048, 4096],
    )
    ap.add_argument(
        "--plot",
        default=None,
        metavar="OUT.pdf",
        help="write the crossover chart (reference walsh_plot.py's "
        "compute-performance-all.pdf counterpart)",
    )
    args = ap.parse_args()
    sweep(args.batch, args.iters, args.sizes, args.plot)


def sweep(batch, iters, sizes, plot=None):
    """Time the three transforms at each D in ``sizes``, print one JSON
    row per D and the crossover, and write the chart to ``plot`` if
    given. Runs in the caller's process (one process per card)."""
    print(f"backend={jax.default_backend()}")
    crossover = None
    rows = []
    for D in sizes:
        x = jax.jit(
            lambda k, s: jax.random.normal(k, s), static_argnums=1
        )(jax.random.PRNGKey(0), (batch, D))
        scale = 1.0 / jnp.sqrt(jnp.float32(D))  # keep chains bounded
        H = build_H(D) * scale

        t_matmul = chain_time(lambda v: v @ H, x, iters)
        t_butter = chain_time(lambda v: fwht_butterfly(v) * scale, x, iters)
        t_kron = chain_time(lambda v: fwht_kron(v) * scale, x, iters)
        row = {
            "D": D,
            "matmul_us": round(t_matmul * 1e6, 1),
            "butterfly_us": round(t_butter * 1e6, 1),
            "kron_us": round(t_kron * 1e6, 1),
        }
        if crossover is None and min(t_butter, t_kron) < t_matmul:
            crossover = D
            row["crossover"] = True
        rows.append(row)
        print(json.dumps(row), flush=True)
    if plot:
        _write_plot(rows, crossover, plot, jax.default_backend())
    print(
        json.dumps(
            {
                "crossover_D": crossover,
                "reference_claim": "vectorized CPU FWHT beats matmul from "
                "D ~ 2^11 (performance-testing.tex:16-17)",
            }
        )
    )


if __name__ == "__main__":
    main()
