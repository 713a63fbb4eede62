"""Large-D scaling experiment: WHVI MLP at D up to 8192+, MC-ELBO
throughput across mesh layouts.

BASELINE.json config: "Large-D scaling: WHVI MLP D=8192, MC ELBO
samples sharded over devices with psum gradient reduction". On one card
this measures ELBO steps/s vs D and MC-sample count; on a mesh of cards
(or the 8-virtual-device CPU backend, --force-cpu-devices N) it runs
the sharded step and reports samples/s scaling vs the 1-shard layout.
The first output line names the device the numbers were taken on.

Examples:
  python experiments/run_scaling.py --sizes 1024 4096 8192
  python experiments/run_scaling.py --force-cpu-devices 8 --mesh 2x4
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

import numpy as np


def _round(v, nd):
    return None if v is None else round(v, nd)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[1024, 4096, 8192])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--samples", type=int, default=8, help="MC samples")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x sample)")
    ap.add_argument("--force-cpu-devices", type=int, default=0)
    ap.add_argument(
        "--predict",
        action="store_true",
        help="benchmark the SERVING path instead of training: "
        "posterior-predictive inference through make_sharded_predict "
        "(MC samples over the sample axis, batch over data)",
    )
    ap.add_argument(
        "--precision",
        default="default",
        choices=("default", "highest", "bf16"),
        help="operand precision of the Kronecker FWHT path "
        "(default = TF32 operands on the GPU; highest = true fp32 via "
        "Precision.HIGHEST; bf16 = bfloat16 operands)",
    )
    ap.add_argument(
        "--dtype",
        default="f32",
        choices=("f32", "bf16"),
        help="parameter/activation dtype: bf16 halves HBM transport of "
        "the layer-to-layer and transform-to-transform activations "
        "(accumulation stays fp32) — the lever for the memory-bound "
        "large-D regime",
    )
    ap.add_argument(
        "--repeats",
        type=int,
        default=1,
        help="independent measured repeats per row (all reported, so "
        "the spread is visible)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.force_cpu_devices:
        jax.config.update("jax_num_cpu_devices", args.force_cpu_devices)
        jax.config.update("jax_platforms", "cpu")

    from whvi_tpu.models import WHVILinear, WHVIRegression, relu
    from whvi_tpu.ops import set_fwht_precision
    from whvi_tpu.parallel import make_mesh, make_sharded_train_step
    from whvi_tpu.train import Trainer, TrainConfig, decayed_adam
    from whvi_tpu.utils import (
        elbo_step_flops,
        enable_compile_cache,
        mfu,
        whvi_mul_flops,
    )

    enable_compile_cache()
    set_fwht_precision(args.precision)  # read at trace time
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": jax.device_count(),
            }
        ),
        flush=True,
    )

    for D in args.sizes:
        net = WHVIRegression(
            [
                WHVILinear(D, D, lambda_=3.0, s_init="auto"),
                relu,
                WHVILinear(D, D, lambda_=3.0, s_init="auto"),
                relu,
                WHVILinear(D, 1, s_init="auto"),
            ],
            train_samples=args.samples,
        )
        rng = np.random.RandomState(0)
        dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
        X = jnp.asarray(rng.randn(args.batch, D), dtype)
        y = jnp.asarray(rng.randn(args.batch, 1), dtype)

        if args.mesh:
            d, s = (int(v) for v in args.mesh.split("x"))
            mesh = make_mesh(data=d, sample=s)
        else:
            mesh = make_mesh(data=1, sample=1)

        if args.predict:
            # ---- serving path: posterior-predictive inference bench
            from functools import partial

            from jax.sharding import NamedSharding, PartitionSpec as P

            from whvi_tpu.parallel import make_sharded_predict

            pred = make_sharded_predict(net, mesh, n_samples=args.samples)
            params = jax.device_put(
                Trainer(net, TrainConfig())
                .init(jax.random.PRNGKey(0), dtype=dtype)
                .params,
                NamedSharding(mesh, P()),
            )
            xs = jax.device_put(
                jnp.asarray(X), NamedSharding(mesh, P("data"))
            )

            @partial(jax.jit, static_argnames="k")
            def pred_scan(key, k):
                # k serving calls inside one compiled scan; the summed
                # output forces completion on fetch
                def body(carry, _):
                    key, acc = carry
                    key, sub = jax.random.split(key)
                    acc = acc + jnp.sum(pred.raw(params, sub, xs))
                    return (key, acc), None

                (_, acc), _ = jax.lax.scan(
                    body, (key, jnp.float32(0)), None, length=k
                )
                return acc

            def prun(k):
                t0 = time.perf_counter()
                float(pred_scan(jax.random.PRNGKey(1), k))
                return time.perf_counter() - t0

            # forward-only matmul flops: 2 square layers, ONE fused product
            # each (the merged-u LRT; see utils.profiling
            # whvi_layer_fwd_flops — the earlier 2-product count produced
            # an impossible >100%-MFU row, caught by this very audit)
            flops = args.samples * 2 * whvi_mul_flops(D, args.batch)
            prun(args.steps)
            prun(2 * args.steps)
            for _ in range(args.repeats):
                t1 = prun(args.steps)
                t2 = prun(2 * args.steps)
                dt = max(t2 - t1, 1e-9) / args.steps
                print(
                    json.dumps(
                        {
                            "D": D,
                            "mode": "predict",
                            "batch": args.batch,
                            "mc_samples": args.samples,
                            "mesh": dict(mesh.shape),
                            "precision": args.precision,
                            "dtype": args.dtype,
                            "call_ms": round(dt * 1e3, 3),
                            "pred_samples_per_s": round(
                                args.samples * args.batch / dt, 1
                            ),
                            "tflops": round(flops / dt / 1e12, 1),
                            "mfu": _round(
                                mfu(flops / dt, dev, args.precision), 3
                            ),
                        }
                    ),
                    flush=True,
                )
            continue

        tx = decayed_adam()
        step, shard_state, shard_batch = make_sharded_train_step(
            net, tx, mesh, n_samples=args.samples
        )
        trainer = Trainer(net, TrainConfig())
        state = shard_state(trainer.init(jax.random.PRNGKey(0), dtype=dtype))
        xb, yb = shard_batch(X, y)

        # All steps of a measurement run inside ONE compiled lax.scan
        # (step.scan), and the sync is a host fetch of the final loss.
        # Difference timing (2N vs N) cancels the per-call dispatch/fetch
        # latency.
        def run(k, state):
            t0 = time.perf_counter()
            state, metrics = step.scan(state, xb, yb, args.batch, 1.0, k)
            float(metrics["loss"])  # host sync
            return time.perf_counter() - t0, state

        # fwd+bwd matmul flops of the 2 square LRT layers (the D->1 column
        # output layer is O(D), <1% -- see utils.profiling)
        flops = elbo_step_flops([D, D], args.batch, args.samples)
        _, state = run(args.steps, state)  # compile k
        _, state = run(2 * args.steps, state)  # compile 2k
        for _ in range(args.repeats):
            t1, state = run(args.steps, state)
            t2, state = run(2 * args.steps, state)
            dt = max(t2 - t1, 1e-9) / args.steps
            print(
                json.dumps(
                    {
                        "D": D,
                        "batch": args.batch,
                        "mc_samples": args.samples,
                        "mesh": dict(mesh.shape),
                        "precision": args.precision,
                        "dtype": args.dtype,
                        "step_ms": round(dt * 1e3, 2),
                        "elbo_steps_per_s": round(1.0 / dt, 2),
                        "posterior_samples_per_s": round(
                            args.samples * args.batch / dt, 1
                        ),
                        "tflops": round(flops / dt / 1e12, 1),
                        "mfu": _round(mfu(flops / dt, dev, args.precision), 3),
                    }
                ),
                flush=True,
            )


if __name__ == "__main__":
    main()
