"""Tests for the training engine: schedule, two-phase freeze, fit loop,
checkpoint/resume. The reference's training loop is untested (SURVEY.md
section 4 "what is not tested"); these close that gap.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from whvi_tpu.models import WHVILinear, WHVIRegression, relu
from whvi_tpu.train import (
    TrainConfig,
    Trainer,
    decay_schedule,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)


def _toy_data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    w = rng.randn(4, 1).astype(np.float32)
    y = X @ w + 0.1 * rng.randn(n, 1).astype(np.float32)
    return X, y


def _small_net():
    return WHVIRegression(
        [WHVILinear(4, 8, lambda_=1.0), relu, WHVILinear(8, 1)],
        train_samples=1,
        eval_samples=8,
    )


def test_decay_schedule_single_applied():
    # lr(t) = lr0 * (1 + gamma t)^-p — documented schedule (README), not
    # the reference code's accidental lr0^2 version (evaluation.py:25-27).
    s = decay_schedule(lr0=1e-3, gamma=5e-4, p=0.3)
    np.testing.assert_allclose(float(s(0)), 1e-3, rtol=1e-6)
    np.testing.assert_allclose(
        float(s(1000)), 1e-3 * (1.5) ** (-0.3), rtol=1e-5
    )


def test_train_step_reduces_loss():
    X, y = _toy_data()
    net = _small_net()
    trainer = Trainer(
        net, TrainConfig(epochs1=0, epochs2=60, epochs_per_call=30)
    )
    state = trainer.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    loss0, _ = net.loss(state.params, key, jnp.asarray(X), jnp.asarray(y), n=len(X))
    state, logs = trainer.fit(state, X, y)
    loss1, _ = net.loss(state.params, key, jnp.asarray(X), jnp.asarray(y), n=len(X))
    assert float(loss1) < float(loss0)
    assert logs[-1]["epoch"] == 60


def test_phase1_freezes_likelihood_sigma():
    # The freeze must be real (reference bug 3: its phase 1 still updates
    # sigma through Adam).
    X, y = _toy_data()
    net = _small_net()
    trainer = Trainer(
        net, TrainConfig(epochs1=20, epochs2=0, epochs_per_call=10)
    )
    state = trainer.init(jax.random.PRNGKey(2))
    rho_before = float(state.params["likelihood"]["rho"])
    state, _ = trainer.fit(state, X, y)
    rho_after = float(state.params["likelihood"]["rho"])
    assert rho_before == rho_after
    # ...while other params did move
    s1_moved = float(
        jnp.abs(
            state.params["layers"][0]["s1"]
        ).max()
    )
    assert s1_moved > 0


def test_phase2_trains_likelihood_sigma():
    X, y = _toy_data()
    net = _small_net()
    trainer = Trainer(
        net, TrainConfig(epochs1=0, epochs2=20, epochs_per_call=10)
    )
    state = trainer.init(jax.random.PRNGKey(3))
    rho_before = float(state.params["likelihood"]["rho"])
    state, _ = trainer.fit(state, X, y)
    assert float(state.params["likelihood"]["rho"]) != rho_before


def _hetero_split_net():
    import dataclasses

    from whvi_tpu.models import (
        HeteroscedasticGaussianLikelihood,
        Parallel,
    )

    net = WHVIRegression(
        [
            WHVILinear(4, 8, lambda_=1.0),
            relu,
            Parallel(
                (WHVILinear(8, 1, lambda_=1e-5), WHVILinear(8, 1, lambda_=1.0))
            ),
        ],
        train_samples=2,
        eval_samples=4,
    )
    return dataclasses.replace(
        net, likelihood=HeteroscedasticGaussianLikelihood(sigma0=0.3)
    )


def test_noise_branch_freeze_schedule():
    # noise_freeze_steps: the noise branch must hold its init while the
    # mean branch trains, then move once past the threshold.
    X, y = _toy_data()
    net = _hetero_split_net()
    # 20 epochs x 1 batch of 64 = 20 steps; freeze for the first 10
    cfg = TrainConfig(
        epochs1=0, epochs2=10, epochs_per_call=10, noise_freeze_steps=10
    )
    trainer = Trainer(net, cfg)
    state = trainer.init(jax.random.PRNGKey(4))
    snap = lambda s, i: [
        np.array(a) for a in jax.tree.leaves(s.params["layers"][-1]["branches"][i])
    ]
    noise0, mean0 = snap(state, 1), snap(state, 0)
    state, _ = trainer.fit(state, X, y)
    noise1, mean1 = snap(state, 1), snap(state, 0)
    for a, b in zip(noise0, noise1):
        np.testing.assert_array_equal(a, b)
    assert any(float(np.abs(a - b).max()) > 0 for a, b in zip(mean0, mean1))
    # continue past the threshold: now the noise branch moves too
    state, _ = trainer.fit(state, X, y)
    noise2 = snap(state, 1)
    assert any(float(np.abs(a - b).max()) > 0 for a, b in zip(noise1, noise2))


def test_evaluate_metrics():
    X, y = _toy_data()
    net = _small_net()
    trainer = Trainer(net, TrainConfig(epochs1=0, epochs2=10))
    state = trainer.init(jax.random.PRNGKey(4))
    state, _ = trainer.fit(state, X, y)
    m = trainer.evaluate(state.params, X, y, jax.random.PRNGKey(5))
    assert np.isfinite(m["rmse"])
    assert np.isfinite(m["mnll"])
    assert abs(m["mnll_per_point"] - m["mnll"] / len(X)) < 1e-3


def test_checkpoint_roundtrip(tmp_path):
    net = _small_net()
    trainer = Trainer(net)
    state = trainer.init(jax.random.PRNGKey(6))
    path = str(tmp_path / "ckpt-10.npz")
    save_checkpoint(path, state, {"epoch": 10})
    template = trainer.init(jax.random.PRNGKey(7))
    restored, meta = restore_checkpoint(path, template)
    assert meta["epoch"] == 10
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert latest_checkpoint(str(tmp_path)) == path


def test_fit_resume_from_checkpoint(tmp_path):
    X, y = _toy_data()
    net = _small_net()
    cfg = TrainConfig(
        epochs1=0, epochs2=20, epochs_per_call=5, checkpoint_every=10
    )
    ckpt_dir = str(tmp_path / "ck")
    trainer = Trainer(net, cfg)
    state = trainer.init(jax.random.PRNGKey(8))
    state_full, _ = trainer.fit(state, X, y, ckpt_dir=ckpt_dir)
    # the run checkpointed at 10 and 20; wipe the 20 and resume from 10
    import os

    os.remove(os.path.join(ckpt_dir, "ckpt-20.npz"))
    trainer2 = Trainer(net, cfg)
    state2 = trainer2.init(jax.random.PRNGKey(9))
    state_resumed, logs = trainer2.fit(
        state2, X, y, ckpt_dir=ckpt_dir, resume=True
    )
    # resumed from epoch 10: the first logged chunk continues past it
    assert logs[0]["epoch"] > 10
    assert int(state_resumed.step) == int(state_full.step)


def test_uneven_batches_static_shapes():
    # n=50 with batch 64 -> single wrapped batch; n=70 with batch 64 ->
    # two batches (wrap-padded). Both must run under one jit.
    net = _small_net()
    for n in (50, 70):
        X, y = _toy_data(n=n)
        trainer = Trainer(
            net, TrainConfig(epochs1=0, epochs2=4, epochs_per_call=2)
        )
        state = trainer.init(jax.random.PRNGKey(10))
        state, logs = trainer.fit(state, X, y)
        assert logs[-1]["epoch"] == 4


def test_ignore_kl_config():
    X, y = _toy_data()
    net = _small_net()
    trainer = Trainer(
        net, TrainConfig(epochs1=0, epochs2=5, ignore_kl=True)
    )
    state = trainer.init(jax.random.PRNGKey(11))
    state, logs = trainer.fit(state, X, y)
    # with ignore_kl the loss equals the mnll
    np.testing.assert_allclose(logs[-1]["loss"], logs[-1]["mnll"], rtol=1e-5)


def test_kl_warmup_ramps():
    # with kl_warmup_steps the effective KL weight starts at ~0: two
    # trainers differing only in warmup produce different param updates
    X, y = _toy_data()
    net = _small_net()
    t_warm = Trainer(
        net, TrainConfig(epochs1=0, epochs2=4, kl_warmup_steps=1000)
    )
    t_nowarm = Trainer(net, TrainConfig(epochs1=0, epochs2=4))
    s0 = t_warm.init(jax.random.PRNGKey(20))
    s1 = t_nowarm.init(jax.random.PRNGKey(20))
    s0, _ = t_warm.fit(s0, X, y)
    s1, _ = t_nowarm.fit(s1, X, y)
    d = max(
        float(jnp.abs(a - b).max())
        for a, b in zip(jax.tree.leaves(s0.params), jax.tree.leaves(s1.params))
    )
    assert d > 0


def test_s_init_auto():
    from whvi_tpu.models import SquarePow2Matrix

    m = SquarePow2Matrix(64, s_init="auto")
    p = m.init(jax.random.PRNGKey(21))
    std = float(jnp.std(p["s1"]))
    assert 0.7 * 64**-0.5 < std < 1.3 * 64**-0.5


def test_noise_freeze_requires_split_head():
    # Misconfiguration must raise up front, not silently skip the
    # curriculum (round-3 VERDICT weak #5 / advisor finding).
    import pytest

    net = _small_net()
    with pytest.raises(ValueError, match="split head"):
        Trainer(net, TrainConfig(noise_freeze_steps=5))


def test_vmap_splits_and_mesh_mutually_exclusive():
    import pytest

    from whvi_tpu.parallel import make_mesh

    net = _small_net()
    mesh = make_mesh(data=2, sample=4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(net, TrainConfig(), mesh=mesh, vmap_splits=True)


def test_checkpoint_every_zero_with_ckpt_dir(tmp_path):
    # checkpoint_every=0 is the "disable periodic checkpoints" idiom;
    # with a ckpt_dir it must still save the FINAL checkpoint and not
    # divide by zero (round-4 review finding #4).
    X, y = _toy_data()
    net = _small_net()
    trainer = Trainer(
        net, TrainConfig(epochs1=0, epochs2=4, checkpoint_every=0)
    )
    state = trainer.init(jax.random.PRNGKey(0))
    state, _ = trainer.fit(state, X, y, ckpt_dir=str(tmp_path))
    import os

    files = sorted(
        f for f in os.listdir(tmp_path) if f.startswith("ckpt-")
    )
    assert files == ["ckpt-4.npz", "ckpt-4.npz.meta.json"]


def test_trainer_runs_with_rbg_keys():
    # the round-5 --prng rbg lever: the whole
    # trainer pipeline — init, scanned epochs, per-example LRT noise,
    # eval — must work with typed rbg keys (no global config flip,
    # which would leak into other tests)
    import dataclasses

    X, y = _toy_data()
    net = _small_net()
    net = dataclasses.replace(
        net,
        layers=tuple(
            dataclasses.replace(l, per_example_noise=True)
            if hasattr(l, "per_example_noise")
            else l
            for l in net.layers
        ),
    )
    trainer = Trainer(net, TrainConfig(epochs1=1, epochs2=3))
    # typed keys carry their impl (raw PRNGKey(impl=...) arrays would
    # be re-interpreted under the global default impl downstream)
    key = jax.random.key(0, impl="rbg")
    state = trainer.init(key)
    state, logs = trainer.fit(state, X, y)
    assert np.isfinite(logs[-1]["loss"])
    m = trainer.evaluate(
        state.params, X, y, jax.random.key(1, impl="rbg")
    )
    assert np.isfinite(m["rmse"])
