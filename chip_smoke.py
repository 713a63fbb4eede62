"""Bring-up check: drive the main paths once on one NVIDIA GPU.

    python chip_smoke.py           # one card, every phase below
    python chip_smoke.py --four    # four cards: the mesh path only

Phases (one process; each prints its comparisons as ``err`` beside
``tol`` and its compile seconds, which are set-up time):

  ops       fwht / whvi_mul at D in {1024, 4096, 16384}, batch 256, in
            the three precision modes against a float64 NumPy oracle
            built from ``build_H``; the VJP of whvi_mul against the dense
            oracle's; the time of whvi_mul at batch 256x8 and its share
            of the memory-bandwidth bound.
  train     the large-D model of experiments/run_scaling.py at full width
            (4096-4096-4096-1, 8 MC samples, batch 256): the first
            step's loss and gradients against the same jitted step on
            the CPU, then Trainer.fit for 1+2 epochs and Trainer.evaluate
            (64-sample posterior predictive).
  protocol  the 8-split vmapped UCI protocol on kin8nm-shaped synthetic
            data (n=8192, 8 features), short epochs.
  mcmc      NUTS and parallel-tempering chains on the flagship network's
            g-posterior.
  toy       bench.py's toy configuration, in this process.
  gpu_tests the tests marked ``gpu`` (tests/test_gpu.py).

``--four`` runs only the multi-card path on a (data=2, sample=2) mesh:
the sharded loss and gradients against one card, the sharded train step,
the mesh Trainer with make_sharded_predict against single-card
predictions, the split-sharded protocol against the unsharded one, and
sharded NUTS chains.

The script refuses to run (exit 1, no result line) when JAX's first
device is not a GPU or when the repository is not beside it. Any failed
phase makes it exit 1 without the result line. The last line on success
is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# --------------------------------------------------------------- tolerances
# Max |got - ref| over max |ref| against a float64 oracle. The operands
# decide the error: "highest" multiplies true fp32 (float32 rounding of
# the sums only), "default" runs fp32 operands in TF32 on the card
# (10-bit mantissa), "bf16" in bfloat16 (8-bit mantissa). Measured on an
# H100 (400 W limit) over D in {1024, 4096, 16384}, batch 256, fwht and
# whvi_mul: highest <= 5.6e-7, default 2.9e-4..4.7e-4, bf16
# 2.4e-3..3.4e-3. Each bound sits a few times above its mode's error and
# below the next coarser mode's, so a change of mode or a broken
# transform fails while summation-order noise does not.
OPS_TOL = {"highest": 1e-5, "default": 2e-3, "bf16": 1e-2}
# The VJP of whvi_mul vs the dense oracle's VJP, both in true fp32
# (measured <= 1.6e-6 at D=4096).
VJP_TOL = 1e-5
# First train step on the card vs the CPU, both at "highest": the same
# program in float32, so only the order of the sums differs (cuBLAS and
# XLA:GPU reduce in another order than the CPU backend). Measured at
# D=4096: loss 8.4e-8; gradients 9.9e-5 (max over leaves of max error
# over max |grad|, set by the leaf whose gradient sums the most
# cancelling terms), hence 1e-3.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3
# Four cards vs one: the psum over (data, sample) adds the shards'
# partial sums in another order than the single-card mean. Measured on
# four H100s (700 W limit) at D=4096: loss 0, gradients 1.1e-5 (max
# over leaves), sharded predict 0, per-split protocol RMSE 1.0e-7.
FOUR_LOSS_RTOL = 1e-5
FOUR_GRAD_RTOL = 1e-4
FOUR_PRED_RTOL = 1e-5
FOUR_PROTOCOL_RTOL = 1e-5

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class Report:
    """Collects one phase's comparisons; a phase fails if any did."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failures: list[str] = []

    def info(self, msg: str) -> None:
        print(f"[{self.phase}] {msg}", flush=True)

    def check(self, name: str, err: float, tol: float) -> None:
        ok = bool(err <= tol)  # NaN fails
        self.info(f"{name}: err={err:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)

    def require(self, name: str, cond: bool) -> None:
        self.info(f"{name}: {'ok' if cond else 'FAIL'}")
        if not cond:
            self.failures.append(name)


def _rel(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _tree_rel(got, ref) -> float:
    import jax

    return max(_rel(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)))


def _finite(tree) -> bool:
    import jax
    import numpy as np

    return all(bool(np.isfinite(np.asarray(l)).all()) for l in jax.tree.leaves(tree))


def _host_H(D: int):
    """Float64 Sylvester H_D from ``build_H``; above 4096 as the
    Kronecker product H_{D/4096} (x) H_4096, which is the same matrix."""
    import numpy as np

    from whvi_tpu.ops import build_H

    if D <= 4096:
        return np.asarray(build_H(D), np.float64)
    return np.kron(_host_H(D // 4096), _host_H(4096))


def _big_net(D: int, train_samples: int = 8):
    from whvi_tpu.models import WHVILinear, WHVIRegression, relu

    return WHVIRegression(
        [
            WHVILinear(D, D, lambda_=3.0, s_init="auto"),
            relu,
            WHVILinear(D, D, lambda_=3.0, s_init="auto"),
            relu,
            WHVILinear(D, 1, s_init="auto"),
        ],
        train_samples=train_samples,
        eval_samples=64,
    )


def _regression_data(n: int, d: int, seed: int):
    import numpy as np

    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d).astype(np.float32) / np.sqrt(d)
    y = (np.tanh(X @ w) + 0.05 * rng.randn(n)).astype(np.float32)[:, None]
    return X, y


# ------------------------------------------------------------------- phases
def phase_ops(rep: Report, sizes=(1024, 4096, 16384), batch=256, vjp_D=4096,
              time_sizes=(4096, 16384), time_rows=256 * 8):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from whvi_tpu.ops import fwht, set_fwht_precision, whvi_mul
    from whvi_tpu.ops import whvi_mul_dense_oracle
    from whvi_tpu.utils import chain_time, hbm_bytes_per_s, whvi_mul_flops
    from whvi_tpu.utils import peak_flops

    rng = np.random.RandomState(0)
    for D in sizes:
        H = _host_H(D)
        x = rng.randn(batch, D).astype(np.float32)
        s1 = (rng.randn(D) * 0.1).astype(np.float32)
        u = rng.randn(D).astype(np.float32)
        s2 = (rng.randn(D) * 0.1).astype(np.float32)
        x64 = x.astype(np.float64)
        ref_fwht = x64 @ H
        ref_mul = s1 * ((u * ((s2 * x64) @ H)) @ H)
        for mode in ("highest", "default", "bf16"):
            got = jax.jit(lambda v, m=mode: fwht(v, precision=m))(x)
            rep.check(f"fwht D={D} {mode}", _rel(got, ref_fwht), OPS_TOL[mode])
            set_fwht_precision(mode)
            try:  # the module default is read while tracing
                got = jax.jit(lambda *a: whvi_mul(*a))(s1, u, s2, x)
            finally:
                set_fwht_precision("default")
            rep.check(f"whvi_mul D={D} {mode}", _rel(got, ref_mul), OPS_TOL[mode])
        del H

    # VJP of whvi_mul against the dense oracle's, both in true fp32
    D = vjp_D
    args = [jnp.asarray(rng.randn(*s).astype(np.float32) * c)
            for s, c in (((D,), 0.1), ((D,), 1.0), ((D,), 0.1), ((batch, D), 1.0))]
    g = jnp.asarray(rng.randn(batch, D).astype(np.float32))

    def vjp_of(f):
        return jax.jit(lambda *a: jax.vjp(f, *a)[1](g))

    with jax.default_matmul_precision("highest"):
        got = vjp_of(whvi_mul)(*args)
        ref = vjp_of(whvi_mul_dense_oracle)(*args)
    for name, a, b in zip(("s1", "u", "s2", "x"), got, ref):
        rep.check(f"vjp whvi_mul d{name} D={D} highest", _rel(a, b), VJP_TOL)

    # time of the XLA product and its share of the memory bound (one read
    # of x and one write of y in fp32); random-sign diagonals scaled by
    # D^(-1/3) keep the chained iterate's norm fixed
    dev = jax.devices()[0]
    for D in time_sizes:
        c = D ** (-1.0 / 3.0)
        d1, d2, d3 = (jnp.asarray(c * np.sign(rng.randn(D)), jnp.float32)
                      for _ in range(3))
        x = jax.random.normal(jax.random.PRNGKey(D), (time_rows, D))
        nbytes = 2 * time_rows * D * 4
        t_copy = chain_time(lambda v: -v, x, iters=50)
        line = (f"copy-like negate D={D} rows={time_rows}: "
                f"{t_copy * 1e6:.2f} us")
        if dev.platform == "gpu":
            line += f", {nbytes / t_copy / hbm_bytes_per_s(dev.device_kind):.3f} of HBM peak"
        rep.info(line)
        for mode in ("default", "highest", "bf16"):
            set_fwht_precision(mode)
            try:
                t = chain_time(lambda v: whvi_mul(d1, d2, d3, v), x, iters=50)
            finally:
                set_fwht_precision("default")
            line = (f"time whvi_mul D={D} rows={time_rows} {mode}: "
                    f"{t * 1e6:.2f} us, {nbytes / t / 1e9:.1f} GB/s, "
                    f"{whvi_mul_flops(D, time_rows) / t / 1e12:.2f} TFLOP/s")
            if dev.platform == "gpu":
                kind = dev.device_kind
                line += (
                    f", memory-bound share {nbytes / hbm_bytes_per_s(kind) / t:.3f}"
                    f", compute share {whvi_mul_flops(D, time_rows) / peak_flops(kind, mode) / t:.3f}"
                )
            rep.info(line)


def phase_train(rep: Report, D=4096, n=2048, batch=256, train_samples=8,
                epochs1=1, epochs2=2):
    import jax
    import numpy as np

    from whvi_tpu.train import TrainConfig, Trainer

    net = _big_net(D, train_samples)
    X, y = _regression_data(n + batch, D, seed=1)
    X_te, y_te = X[n:], y[n:]
    X, y = X[:n], y[:n]
    trainer = Trainer(
        net,
        TrainConfig(batch_size=batch, epochs1=epochs1, epochs2=epochs2,
                    checkpoint_every=0),
    )
    state = trainer.init(jax.random.PRNGKey(0))

    # first step on the card vs the same jitted step on the CPU; the
    # default threefry keys draw the same bits on both backends (rbg
    # streams are backend-specific)
    key = jax.random.PRNGKey(1)
    x0, y0 = X[:batch], y[:batch]
    step = jax.jit(jax.value_and_grad(
        lambda p, k, a, b: net.loss(p, k, a, b, n=n)[0]))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        loss_dev, g_dev = step(state.params, key, x0, y0)
        loss_cpu, g_cpu = step(*jax.device_put((state.params, key, x0, y0), cpu))
    rep.check("first-step loss vs CPU", _rel(loss_dev, loss_cpu), TRAIN_LOSS_RTOL)
    rep.check("first-step grads vs CPU (max over leaves)",
              _tree_rel(g_dev, g_cpu), TRAIN_GRAD_RTOL)

    compiled = jax.jit(trainer.train_step).lower(
        state, x0, y0, n, 1.0).compile()
    mem = compiled.memory_analysis()
    if mem is not None:
        rep.info(
            "train_step memory_analysis: "
            + ", ".join(f"{f}={getattr(mem, f)}" for f in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes",
                "generated_code_size_in_bytes") if hasattr(mem, f)))

    t0 = time.perf_counter()
    state, logs = trainer.fit(state, X, y)
    steps = int(state.step)
    rep.info(f"fit: {steps} steps in {time.perf_counter() - t0:.2f} s "
             f"(compile included), last loss {logs[-1]['loss']:.4f}")
    rep.require(f"fit ran {(epochs1 + epochs2) * (-(-n // batch))} steps",
                steps == (epochs1 + epochs2) * (-(-n // batch)))
    rep.require("fit losses finite",
                bool(np.isfinite([l["loss"] for l in logs]).all()))
    metrics = trainer.evaluate(state.params, X_te, y_te, jax.random.PRNGKey(2))
    rep.info(f"evaluate ({net.eval_samples} samples): {metrics}")
    rep.require("evaluate metrics finite", _finite(metrics))


def phase_protocol(rep: Report, n=8192, features=8, n_splits=8, epochs1=2,
                   epochs2=8, hidden=(128, 128)):
    import numpy as np

    from whvi_tpu.evaluation import ProtocolConfig, evaluate_bayesian_regression

    X, y = _regression_data(n, features, seed=2)
    cfg = ProtocolConfig(
        n_splits=n_splits, epochs1=epochs1, epochs2=epochs2, hidden=hidden,
        checkpoint_every=0, bias=True, per_example_noise=True,
        train_samples=8, sigma0=0.1,
    )
    out = evaluate_bayesian_regression(X, y, cfg)
    rep.info(f"rmse {out['rmse_mean']:.4f} +- {out['rmse_sd']:.4f}, mnll/pt "
             f"{out['mnll_per_point_mean']:.4f}, wall {out['protocol_wall_s']:.2f} s "
             "(compile included)")
    rep.require("vmapped_splits", bool(out.get("vmapped_splits")))
    rep.require(f"{n_splits} splits", len(out["splits"]) == n_splits)
    rep.require("metrics finite", bool(np.isfinite(
        [out["rmse_mean"], out["mnll_mean"], out["mnll_per_point_mean"]]).all()))


def _flagship(hidden=(128, 128)):
    """The flagship UCI-protocol network (__graft_entry__.py)."""
    from whvi_tpu.models import WHVIRegression, mlp_layers

    return WHVIRegression(mlp_layers(13, 1, hidden=hidden),
                          train_samples=4, eval_samples=64)


def phase_mcmc(rep: Report, n_chains=4, n_warmup=20, n_samples=20, rows=64,
               hidden=(128, 128)):
    import jax

    from whvi_tpu.mcmc import NUTSConfig, PTConfig, make_whvi_g_log_posterior
    from whvi_tpu.mcmc import nuts_sample_chains, pt_sample_chains

    net = _flagship(hidden)
    params = jax.jit(net.init)(jax.random.PRNGKey(0))
    X, y = _regression_data(rows, 13, seed=3)
    logp, ginit = make_whvi_g_log_posterior(net, params, X, y)
    gs, _ = nuts_sample_chains(
        logp, ginit, jax.random.PRNGKey(1),
        NUTSConfig(n_warmup=n_warmup, n_samples=n_samples, max_tree_depth=5),
        n_chains=n_chains)
    shapes = {k: v.shape for k, v in gs.items()}
    rep.info(f"NUTS draws {shapes}")
    rep.require("NUTS draws finite", _finite(gs))
    rep.require("NUTS draw shape", all(
        v.shape[:2] == (n_chains, n_samples) for v in gs.values()))
    ts, _ = pt_sample_chains(
        logp, ginit, jax.random.PRNGKey(2),
        PTConfig(n_warmup=n_warmup, n_samples=n_samples, n_rungs=4, n_leapfrog=8),
        n_chains=n_chains)
    rep.require("PT draws finite", _finite(ts))
    rep.require("PT draw shape", all(
        v.shape[:2] == (n_chains, n_samples) for v in ts.values()))


def phase_toy(rep: Report, epochs=1000):
    import math

    sys.path.insert(0, ROOT)
    from bench import toy_run

    row = toy_run(epochs, seeds=(0,))
    rep.info(json.dumps(row))
    rep.require("toy epochs/s positive and losses finite",
                row["value"] > 0 and all(math.isfinite(l) for l in row["final_losses"]))


def phase_gpu_tests(rep: Report):
    """Run the ``gpu``-marked tests in this process (a second JAX process
    could not have the card)."""
    spec = importlib.util.spec_from_file_location(
        "test_gpu", os.path.join(ROOT, "tests", "test_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in sorted(n for n in dir(mod) if n.startswith("test_")):
        try:
            getattr(mod, name)()
            rep.require(name, True)
        except Exception:
            traceback.print_exc()
            rep.require(name, False)


def phase_four(rep: Report, devices, D=4096, batch=256, train_samples=8,
               rows=1024, protocol_n=2048, protocol_epochs=(1, 2),
               hidden=(128, 128)):
    """The (data=2, sample=2) mesh path on four devices against one."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from whvi_tpu.evaluation import ProtocolConfig, evaluate_bayesian_regression
    from whvi_tpu.mcmc import NUTSConfig, make_whvi_g_log_posterior
    from whvi_tpu.mcmc import nuts_sample_chains
    from whvi_tpu.parallel import make_mesh, make_sharded_predict
    from whvi_tpu.parallel import make_sharded_train_step, sharded_loss_fn
    from whvi_tpu.train import TrainConfig, Trainer, decayed_adam

    devices = list(devices)[:4]
    mesh = make_mesh(data=2, sample=2, devices=devices)
    one = devices[0]
    rep.info(f"mesh {dict(mesh.shape)} over {[str(d) for d in devices]}")
    net = _big_net(D, train_samples)
    params = jax.jit(net.init)(jax.random.PRNGKey(0))
    X, y = _regression_data(rows, D, seed=4)
    x, yb = X[:batch], y[:batch]
    key = jax.random.PRNGKey(1)
    rep_s = NamedSharding(mesh, P())
    dat_s = NamedSharding(mesh, P("data"))

    # sharded MC-ELBO loss and gradients vs one device
    loss_fn = sharded_loss_fn(net, mesh, n_samples=train_samples)
    with jax.default_matmul_precision("highest"):
        v_s, g_s = jax.jit(jax.value_and_grad(
            lambda p, k, a, b: loss_fn(p, k, a, b, rows)[0]))(
            jax.device_put(params, rep_s), jax.device_put(key, rep_s),
            jax.device_put(x, dat_s), jax.device_put(yb, dat_s))
        v_1, g_1 = jax.jit(jax.value_and_grad(
            lambda p, k, a, b: net.loss(p, k, a, b, n=rows,
                                        n_samples=train_samples)[0]))(
            *jax.device_put((params, key, x, yb), one))
    rep.check("sharded loss vs one device", _rel(v_s, v_1), FOUR_LOSS_RTOL)
    rep.check("sharded grads vs one device (max over leaves)",
              _tree_rel(g_s, g_1), FOUR_GRAD_RTOL)

    # the raw SPMD train step, a few steps inside one scan
    step, shard_state, shard_batch = make_sharded_train_step(
        net, decayed_adam(), mesh, n_samples=train_samples)
    state = shard_state(Trainer(net, TrainConfig()).init(jax.random.PRNGKey(2)))
    xb_s, yb_s = shard_batch(x, yb)
    state, metrics = step.scan(state, xb_s, yb_s, rows, 1.0, 3)
    rep.require("sharded train step: 3 steps, finite loss",
                int(state.step) == 3 and _finite(metrics))

    # the mesh Trainer and its sharded 64-sample predictive
    mtr = Trainer(net, TrainConfig(batch_size=batch, epochs1=1, epochs2=1,
                                   checkpoint_every=0), mesh=mesh)
    mstate = mtr.init(jax.random.PRNGKey(3))
    mstate, logs = mtr.fit(mstate, X, y)
    ev = mtr.evaluate(mstate.params, X[:batch], y[:batch], jax.random.PRNGKey(4))
    rep.info(f"mesh Trainer: last loss {logs[-1]['loss']:.4f}, eval {ev}")
    rep.require("mesh Trainer fit/evaluate finite",
                _finite([l["loss"] for l in logs]) and _finite(ev))
    pred = make_sharded_predict(net, mesh, n_samples=net.eval_samples)
    with jax.default_matmul_precision("highest"):
        y_s = pred(jax.device_put(params, rep_s), key, jax.device_put(x, dat_s))
        y_1 = jax.jit(lambda p, a, k: net.predict(p, a, k, net.eval_samples))(
            *jax.device_put((params, x, key), one))
    rep.check("sharded predict vs one device", _rel(y_s, y_1), FOUR_PRED_RTOL)

    # split-sharded vmapped protocol vs the same protocol on one device
    Xp, yp = _regression_data(protocol_n, 8, seed=5)
    pcfg = ProtocolConfig(n_splits=8, epochs1=protocol_epochs[0],
                          epochs2=protocol_epochs[1], hidden=hidden,
                          checkpoint_every=0)
    smesh = Mesh(np.asarray(devices), ("split",))
    p4 = evaluate_bayesian_regression(Xp, yp, pcfg, split_mesh=smesh)
    p1 = evaluate_bayesian_regression(Xp, yp, pcfg)
    rep.require("split-sharded protocol vmapped", bool(p4.get("vmapped_splits")))
    rep.check("split-sharded protocol per-split rmse vs one device",
              _rel([s["rmse"] for s in p4["splits"]],
                   [s["rmse"] for s in p1["splits"]]), FOUR_PROTOCOL_RTOL)

    # sharded NUTS chains (chaotic trajectories: checked for finite draws)
    fnet = _flagship(hidden)
    fparams = jax.jit(fnet.init)(jax.random.PRNGKey(5))
    Xf, yf = _regression_data(64, 13, seed=6)
    logp, ginit = make_whvi_g_log_posterior(fnet, fparams, Xf, yf)
    gs, _ = nuts_sample_chains(
        logp, ginit, jax.random.PRNGKey(6),
        NUTSConfig(n_warmup=10, n_samples=10, max_tree_depth=4),
        n_chains=4, mesh=mesh)
    rep.require("sharded NUTS draws finite", _finite(gs))


PHASES = {
    "ops": phase_ops,
    "train": phase_train,
    "protocol": phase_protocol,
    "mcmc": phase_mcmc,
    "toy": phase_toy,
    "gpu_tests": phase_gpu_tests,
}


# --------------------------------------------------------------------- main
def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def run_phase(name, fn, *args) -> bool:
    """Run one phase, printing its compile seconds; True if it passed."""
    from jax import monitoring

    compile_s = [0.0]

    def on_duration(event, secs, **_):
        if event in _COMPILE_EVENTS:
            compile_s[0] += secs

    rep = Report(name)
    monitoring.register_event_duration_secs_listener(on_duration)
    t0 = time.perf_counter()
    try:
        fn(rep, *args)
    except Exception:
        traceback.print_exc()
        rep.failures.append("raised")
    finally:
        monitoring.unregister_event_duration_listener(on_duration)
    status = "ok" if not rep.failures else f"FAILED {rep.failures}"
    rep.info(f"phase {status}; wall {time.perf_counter() - t0:.2f} s, "
             f"of which compile (set-up) {compile_s[0]:.2f} s")
    return not rep.failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        import whvi_tpu
    except ImportError:
        print("chip_smoke: the whvi_tpu package is not beside this script",
              file=sys.stderr)
        return 1
    if os.path.dirname(os.path.dirname(os.path.abspath(whvi_tpu.__file__))) != ROOT:
        print("chip_smoke: whvi_tpu was imported from outside this checkout",
              file=sys.stderr)
        return 1

    import jax

    from whvi_tpu.utils import enable_compile_cache

    cache = enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{devices[0].platform}", file=sys.stderr)
        return 1
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    print(f"device_kind: {devices[0].device_kind}; devices: {len(devices)}; "
          f"jax {jax.__version__}; compile cache {cache}", flush=True)

    if args.four:
        ok = run_phase("four", phase_four, devices)
    else:
        ok = True
        for name, fn in PHASES.items():
            ok = run_phase(name, fn) and ok
    for d in (devices[:4] if args.four else devices[:1]):
        stats = d.memory_stats() or {}
        print(f"{d}: peak_bytes_in_use={stats.get('peak_bytes_in_use')}",
              flush=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
