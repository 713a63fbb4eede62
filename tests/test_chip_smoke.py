"""chip_smoke.py: its refusal off the card and its phases at tiny widths.

On the card the script runs each phase at full width; here every phase
function runs on the CPU at a width small enough for the test suite, and
the four-card path runs on four of the eight virtual CPU devices.
"""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_refuses_on_cpu():
    out = _run(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_refuses_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


TINY = {
    "ops": dict(sizes=(8, 64), batch=5, vjp_D=64, time_sizes=(64,),
                time_rows=16),
    "train": dict(D=16, n=64, batch=16, train_samples=2, epochs1=1,
                  epochs2=1),
    "protocol": dict(n=96, features=8, n_splits=8, epochs1=1, epochs2=2,
                     hidden=(8,)),
    "mcmc": dict(n_chains=2, n_warmup=5, n_samples=5, rows=16, hidden=(8,)),
    "toy": dict(epochs=20),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_passes_at_tiny_width(name):
    rep = chip_smoke.Report(name)
    chip_smoke.PHASES[name](rep, **TINY[name])
    assert rep.failures == []


def test_every_cpu_runnable_phase_is_covered():
    assert set(chip_smoke.PHASES) - set(TINY) == {"gpu_tests"}


def test_four_card_path_on_four_virtual_devices():
    rep = chip_smoke.Report("four")
    chip_smoke.phase_four(
        rep, jax.devices()[:4], D=16, batch=16, train_samples=2, rows=64,
        protocol_n=96, protocol_epochs=(1, 1), hidden=(8,),
    )
    assert rep.failures == []


def test_report_fails_on_nan_and_excess():
    rep = chip_smoke.Report("x")
    rep.check("fine", 1e-6, 1e-5)
    rep.check("too big", 1e-4, 1e-5)
    rep.check("nan", float("nan"), 1e-5)
    rep.require("false", False)
    assert rep.failures == ["too big", "nan", "false"]
