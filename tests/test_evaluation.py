"""UCI evaluation-protocol tests (tiny budgets; the full protocol is
exercised by experiments/run_uci.py)."""

import numpy as np
import jax
import pytest

from whvi_tpu.evaluation import (
    ProtocolConfig,
    evaluate_bayesian_regression,
    standardize,
)


def _data(n=80, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, :1] * 2 + 0.1 * rng.randn(n, 1)).astype(np.float32)
    return X, y


def test_standardize():
    X, _ = _data()
    Xs = standardize(X)
    np.testing.assert_allclose(Xs.mean(axis=0), 0.0, atol=1e-5)
    np.testing.assert_allclose(Xs.std(axis=0), 1.0, atol=1e-4)
    Xtr, Xte = standardize(X[:60], X[60:])
    # test transformed with train statistics
    mu, sd = X[:60].mean(0), X[:60].std(0)
    np.testing.assert_allclose(
        Xte, (X[60:] - mu) / (sd + 1e-8), rtol=1e-4, atol=1e-5
    )


def test_protocol_runs_and_aggregates():
    X, y = _data()
    cfg = ProtocolConfig(
        n_splits=2,
        epochs1=5,
        epochs2=15,
        hidden=(8,),
        checkpoint_every=0,
        kl_warmup_frac=0.0,
    )
    out = evaluate_bayesian_regression(X, y, cfg)
    assert len(out["splits"]) == 2
    for k in ("rmse_mean", "rmse_sd", "mnll_mean", "mnll_per_point_mean"):
        assert np.isfinite(out[k]), k


def test_protocol_normalize_y_metrics_in_original_units():
    X, y = _data()
    y = y * 50.0 + 100.0  # large-scale targets
    cfg = ProtocolConfig(
        n_splits=1,
        epochs1=0,
        epochs2=30,
        hidden=(8,),
        normalize_y=True,
        kl_warmup_frac=0.0,
    )
    out = evaluate_bayesian_regression(X, y, cfg)
    # RMSE must be in original units: a normalized-unit slip would be ~1
    assert out["rmse_mean"] > 5.0


def test_protocol_heteroscedastic():
    X, y = _data()
    cfg = ProtocolConfig(
        n_splits=1,
        epochs1=0,
        epochs2=20,
        hidden=(8,),
        heteroscedastic=True,
        kl_warmup_frac=0.0,
    )
    out = evaluate_bayesian_regression(X, y, cfg)
    assert np.isfinite(out["rmse_mean"])
    assert np.isfinite(out["mnll_mean"])


def test_protocol_multi_output():
    rng = np.random.RandomState(1)
    X = rng.randn(60, 4).astype(np.float32)
    y = np.concatenate([X[:, :1], -X[:, 1:2]], axis=1).astype(np.float32)
    cfg = ProtocolConfig(
        n_splits=1, epochs1=0, epochs2=10, hidden=(8,), kl_warmup_frac=0.0
    )
    out = evaluate_bayesian_regression(X, y, cfg)
    assert np.isfinite(out["rmse_mean"])


def test_vmapped_protocol_matches_sequential():
    # The vmapped-splits protocol must reproduce the sequential loop's
    # per-split results exactly (same per-split PRNG keys; round-3
    # VERDICT next-step #1 "same keys => bit-equal").
    X, y = _data()
    base = dict(
        n_splits=3,
        epochs1=3,
        epochs2=12,
        hidden=(8,),
        checkpoint_every=0,
        kl_warmup_frac=0.1,
    )
    out_seq = evaluate_bayesian_regression(
        X, y, ProtocolConfig(**base, vmap_splits=False)
    )
    out_vmap = evaluate_bayesian_regression(
        X, y, ProtocolConfig(**base, vmap_splits=True)
    )
    assert out_vmap.get("vmapped_splits") is True
    for a, b in zip(out_seq["splits"], out_vmap["splits"]):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=1e-6)
        np.testing.assert_allclose(a["mnll"], b["mnll"], rtol=1e-6)
        np.testing.assert_allclose(
            a["pred_mnll_per_point"], b["pred_mnll_per_point"], rtol=1e-6
        )


@pytest.mark.parametrize("hetero", [False, True])
def test_vmapped_protocol_matches_sequential_normalize_y(hetero):
    # normalize-y (and heteroscedastic) metric conversions go through a
    # different code path in the vmapped protocol — equality must hold
    # there too.
    X, y = _data()
    y = y * 50.0 + 100.0
    base = dict(
        n_splits=2,
        epochs1=0,
        epochs2=10,
        hidden=(8,),
        checkpoint_every=0,
        normalize_y=True,
        heteroscedastic=hetero,
        kl_warmup_frac=0.0,
    )
    out_seq = evaluate_bayesian_regression(
        X, y, ProtocolConfig(**base, vmap_splits=False)
    )
    out_vmap = evaluate_bayesian_regression(
        X, y, ProtocolConfig(**base, vmap_splits=True)
    )
    for a, b in zip(out_seq["splits"], out_vmap["splits"]):
        for k in ("rmse", "mnll", "mnll_per_point"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


def test_vmapped_protocol_checkpoints_and_resumes(tmp_path):
    # The stacked checkpoint must round-trip: a second call with the
    # same ckpt_dir resumes at the saved epoch (no retraining).
    X, y = _data()
    cfg = ProtocolConfig(
        n_splits=2,
        epochs1=0,
        epochs2=10,
        hidden=(8,),
        checkpoint_every=5,
        kl_warmup_frac=0.0,
        vmap_splits=True,
    )
    out1 = evaluate_bayesian_regression(X, y, cfg, ckpt_dir=str(tmp_path))
    import os

    # checkpoints live under a config-hash dir (stale-resume guard)
    (cfg_dir,) = [d for d in os.listdir(tmp_path) if d.startswith("cfg-")]
    files = os.listdir(tmp_path / cfg_dir / "stacked")
    assert any(f.startswith("ckpt-") for f in files)
    out2 = evaluate_bayesian_regression(X, y, cfg, ckpt_dir=str(tmp_path))
    for a, b in zip(out1["splits"], out2["splits"]):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=1e-6)


def test_protocol_column_lrt_smoke():
    # column_lrt + per-example noise through the full vmapped protocol
    X, y = _data()
    cfg = ProtocolConfig(
        n_splits=2,
        epochs1=0,
        epochs2=12,
        hidden=(8,),
        checkpoint_every=0,
        kl_warmup_frac=0.0,
        per_example_noise=True,
        column_lrt=True,
    )
    out = evaluate_bayesian_regression(X, y, cfg)
    assert np.isfinite(out["rmse_mean"])
    # and the flag actually reaches the layers: a run without
    # per_example_noise must give a DIFFERENT result than with it
    # (column LRT only engages when both are set)
    cfg2 = ProtocolConfig(
        n_splits=2,
        epochs1=0,
        epochs2=12,
        hidden=(8,),
        checkpoint_every=0,
        kl_warmup_frac=0.0,
        per_example_noise=True,
        column_lrt=False,
    )
    out2 = evaluate_bayesian_regression(X, y, cfg2)
    assert out["rmse_mean"] != out2["rmse_mean"]


def test_protocol_chunks_follow_epochs_per_call():
    # each trainer log entry closes one scan chunk: phase 1 (2 epochs)
    # is one chunk, phase 2 (7 epochs) splits into 3 + 3 + 1
    X, y = _data()
    logs = []
    cfg = ProtocolConfig(
        n_splits=2,
        epochs1=2,
        epochs2=7,
        epochs_per_call=3,
        hidden=(8,),
        checkpoint_every=0,
    )
    evaluate_bayesian_regression(X, y, cfg, log_fn=logs.append)
    assert [e["epoch"] for e in logs if "phase" in e] == [2, 5, 8, 9]


@pytest.mark.parametrize("grid", [False, True])
def test_large_stack_keeps_configured_chunk(grid, monkeypatch):
    # 16 replicas x 7373 train rows x 2500-epoch chunks: the protocol
    # hands epochs_per_call to the Trainer unchanged at any stack size
    import whvi_tpu.evaluation as evaluation
    import whvi_tpu.train as train

    seen = []

    class Stop(Exception):
        pass

    def spy(net, config, *args, **kwargs):
        seen.append(config.epochs_per_call)
        raise Stop

    monkeypatch.setattr(evaluation, "Trainer", spy)
    monkeypatch.setattr(train, "Trainer", spy)
    X, y = _data(n=8192, d=8)
    cfg = ProtocolConfig(n_splits=8 if grid else 16, epochs_per_call=2500)
    with pytest.raises(Stop):
        if grid:
            evaluation.evaluate_config_grid(X, y, cfg, [{}, {"sigma0": 0.5}])
        else:
            evaluate_bayesian_regression(X, y, cfg)
    assert seen == [2500]
