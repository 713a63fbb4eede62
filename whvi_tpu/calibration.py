"""Post-hoc predictive-variance calibration (temperature scaling).

Round 3 measured miscalibration both ways on the UCI protocol (yacht
homoscedastic coverage95 0.984 over-covered, energy homoscedastic 0.793
under-covered, docs/RESULTS.md) but shipped no mechanism to act on it.
This module is the knob: a single scalar temperature ``tau`` multiplies
the two-moment Gaussian predictive stddev, fitted by maximum likelihood
on a held-out calibration fraction of each train split and applied at
eval time. No reference counterpart (the reference has no calibration
machinery at all; its eval is RMSE + a buggy MNLL, src/networks.py:
101-115).

Math: with predictive moments ``(m_i, s_i)`` and targets ``y_i``, the
Gaussian NLL of ``N(y | m, (tau * s)^2)`` is minimized in closed form by

    tau^2 = mean_i z_i^2,   z_i = (y_i - m_i) / s_i

(stationarity of ``n log tau + sum z_i^2 / (2 tau^2)``). tau > 1 widens
under-covering intervals, tau < 1 tightens over-covering ones; tau is
scale-free (fitted on z-scores), so normalized-target runs calibrate
identically to raw-target runs.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fit_temperature",
    "fit_temperature_quantile",
    "fit_temperature_from_z",
    "coverage",
    "reliability_table",
    "table_from_z",
    "expected_calibration_error",
    "fit_logit_temperature",
    "tempered_mc_probs",
    "DEFAULT_LEVELS",
]

# standard central-interval nominal levels for the 10-bin reliability
# table (VERDICT round 3 next-step #4)
DEFAULT_LEVELS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)


def _z(y: np.ndarray, mean: np.ndarray, sd: np.ndarray) -> np.ndarray:
    y = np.asarray(y, np.float64)
    mean = np.asarray(mean, np.float64)
    sd = np.asarray(sd, np.float64)
    return (y - mean) / np.maximum(sd, 1e-12)


def fit_temperature(
    y: np.ndarray, mean: np.ndarray, sd: np.ndarray
) -> float:
    """Closed-form ML temperature: ``tau = sqrt(mean(z^2))`` over all
    points and output dimensions of the calibration set."""
    z = _z(y, mean, sd)
    return float(np.sqrt(np.mean(np.square(z))))


def fit_temperature_quantile(
    y: np.ndarray,
    mean: np.ndarray,
    sd: np.ndarray,
    level: float = 0.95,
) -> float:
    """Coverage-matched temperature: ``tau = q_level(|z|) / z_crit`` —
    the smallest tau whose ``level`` central interval covers exactly a
    ``level`` fraction of the calibration set. Unlike the ML tau (which
    minimizes Gaussian NLL and lands badly when the predictive is
    non-Gaussian or the calib set is small — measured on yacht: raw
    coverage 0.984, ML tau 0.54 overshot to 0.871), this targets the
    reported metric directly. Noisier on tiny calib sets (it is one
    order statistic), but unbiased for the coverage it calibrates.

    Tiny-set guard: with fewer than ``ceil(1 / (1 - level))`` points
    the level quantile IS the sample max (linnerud: n_cal = 2, tau =
    max|z|/1.96 — arbitrary noise), so this falls back to the ML tau
    with a warning. Pooling calib z-scores across protocol splits
    (``ProtocolConfig.calib_pooled``) is the real fix for small sets.
    """
    z = _z(y, mean, sd).reshape(-1)
    return fit_temperature_from_z(z, mode="quantile", level=level)


def fit_temperature_from_z(
    z: np.ndarray, mode: str = "quantile", level: float = 0.95
) -> float:
    """Temperature from already-standardized residuals ``z = (y - m)/s``
    — the shared core of the per-split and cross-split-pooled fits
    (``z`` is scale-free, so pooling across splits is exact).
    ``mode``: "quantile" (coverage-matched, with the tiny-set ML
    fallback) or "nll" (closed-form Gaussian-ML)."""
    from scipy.stats import norm

    if mode not in ("quantile", "nll"):
        raise ValueError(
            f"mode must be 'quantile' or 'nll', got {mode!r}"
        )
    z = np.asarray(z, np.float64).reshape(-1)
    if mode == "quantile":
        n_min = int(np.ceil(1.0 / max(1.0 - level, 1e-9)))
        if z.size < n_min:
            import warnings

            warnings.warn(
                f"quantile temperature needs >= {n_min} calibration "
                f"points at level {level} (got {z.size}: the quantile "
                "is the sample max); falling back to the ML tau",
                stacklevel=2,
            )
        else:
            zcrit = norm.ppf(0.5 + level / 2.0)
            return float(np.quantile(np.abs(z), level) / zcrit)
    return float(np.sqrt(np.mean(np.square(z))))


def coverage(
    y: np.ndarray,
    mean: np.ndarray,
    sd: np.ndarray,
    level: float = 0.95,
    tau: float = 1.0,
) -> float:
    """Empirical central-interval coverage (PICP) at nominal ``level``
    under the (optionally tempered) Gaussian predictive."""
    from scipy.stats import norm  # scipy ships with the baked-in stack

    zcrit = norm.ppf(0.5 + level / 2.0)
    z = _z(y, mean, sd)
    return float(np.mean(np.abs(z) <= zcrit * tau))


def table_from_z(z: np.ndarray, levels=DEFAULT_LEVELS) -> list[dict]:
    """Reliability table from already-standardized residuals ``z`` —
    used to pool test-set z-scores across protocol splits (apply each
    split's tau by dividing before pooling)."""
    from scipy.stats import norm

    z = np.abs(np.asarray(z, np.float64).reshape(-1))
    return [
        {
            "nominal": float(p),
            "empirical": float(
                np.mean(z <= norm.ppf(0.5 + p / 2.0))
            ),
        }
        for p in levels
    ]


def tempered_mc_probs(logits: np.ndarray, t: float) -> np.ndarray:
    """Posterior-predictive class probabilities at temperature ``t``:
    ``mean_S softmax(logits_s / t)`` for MC logit samples ``(S, N, C)``.
    The ONE implementation shared by the temperature fit and every
    eval-time consumer — temper-then-mix order is part of the fitted
    tau's meaning (round-4 review #8)."""
    z = np.asarray(logits, np.float64) / t
    z = z - z.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    return p.mean(axis=0)


def expected_calibration_error(
    probs: np.ndarray, labels: np.ndarray, n_bins: int = 15
) -> float:
    """Classification ECE: confidence-binned |accuracy − confidence|,
    weighted by bin mass (Guo et al. 2017). ``probs (N, C)`` predictive
    class probabilities, ``labels (N,)`` integer classes."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels).reshape(-1)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    correct = (pred == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    n = len(labels)
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (conf > lo) & (conf <= hi)
        if mask.sum() == 0:
            continue
        ece += (mask.sum() / n) * abs(
            correct[mask].mean() - conf[mask].mean()
        )
    return float(ece)


def fit_logit_temperature(
    logits: np.ndarray,
    labels: np.ndarray,
    taus=None,
    objective: str = "ece",
    return_info: bool = False,
):
    """Classification temperature: scalar T fitted on the calibration
    set over a log-spaced grid, applied as ``mean_S softmax(logits_s /
    T)`` (T composes with the MC mixture rather than replacing it —
    ``logits (S, N, C)`` are MC logit samples).

    ``objective="ece"`` (default) minimizes the calib-set ECE — the
    metric-matched choice, same philosophy as the regression quantile
    tau. "nll" minimizes calib NLL; measured on digits (145-point
    calib): NLL-tau degenerates to the sharp grid edge (a tiny accurate
    calib set always rewards sharpening in-sample) and WORSENS test NLL
    0.124 -> 0.170, while ECE-tau picks an interior optimum
    (round-4 digits run, docs/RESULTS.md).

    Grid-edge guard (round-4 VERDICT weak #3): an argmin on either end
    of the grid is not an optimum — it is the objective still improving
    monotonically as the grid runs out (measured: the w1024 digits
    ECE-tau landed on the 0.05 edge and worsened test NLL 0.124 ->
    0.163). An edge argmin therefore REFUSES the fit: the returned tau
    is 1.0 (identity) and the fit is flagged. ``return_info=True``
    returns ``{"tau", "tau_raw", "tau_at_edge"}`` so callers can
    surface the flag (run_mnist.py reports it in the run JSON).
    """
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels).reshape(-1)
    if taus is None:
        # wide log grid: Bayesian MC-softmax predictives can be
        # strongly UNDERconfident (measured tau ~0.5 on digits w4096),
        # so the sharp end matters as much as the soft end
        taus = np.exp(np.linspace(np.log(0.05), np.log(20.0), 81))

    probs = lambda t: tempered_mc_probs(logits, t)

    if objective == "nll":
        score = lambda t: -np.mean(
            np.log(probs(t)[np.arange(len(labels)), labels] + 1e-12)
        )
    else:
        score = lambda t: expected_calibration_error(probs(t), labels)
    vals = [score(t) for t in taus]
    best = int(np.argmin(vals))
    tau_raw = float(taus[best])
    at_edge = best in (0, len(taus) - 1)
    tau = 1.0 if at_edge else tau_raw
    if at_edge:
        import warnings

        warnings.warn(
            f"logit-temperature argmin landed on the grid edge "
            f"(tau={tau_raw:g}): no interior optimum on the calib set; "
            "refusing the fit (tau=1.0)",
            stacklevel=2,
        )
    if return_info:
        return {"tau": tau, "tau_raw": tau_raw, "tau_at_edge": at_edge}
    return tau


def reliability_table(
    y: np.ndarray,
    mean: np.ndarray,
    sd: np.ndarray,
    tau: float = 1.0,
    levels=DEFAULT_LEVELS,
) -> list[dict]:
    """Nominal-vs-empirical coverage at each level (the 10-bin
    reliability curve). Perfect calibration: empirical == nominal."""
    return [
        {
            "nominal": float(p),
            "empirical": coverage(y, mean, sd, level=p, tau=tau),
        }
        for p in levels
    ]
