"""Multi-host initialization helpers.

One process driving the cards of one host needs nothing; with several
processes (one per host, or one per card) call :func:`init_distributed`
once at program start (before any jax device query) and then build
meshes exactly as in one process — the ``(data, sample)`` mesh in
``parallel.mesh`` spans every process's devices and XLA hands the psum
reductions to NCCL. No framework code changes are needed per host count
(SURVEY.md section 2.6: the reference has no distributed layer at all;
here the same train step scales by re-sharding).

Typical multi-host launch::

    from whvi_tpu.parallel import init_distributed, make_mesh
    init_distributed("localhost:12355", num_processes=2, process_id=rank)
    mesh = make_mesh(data=2, sample=jax.device_count() // 2)
"""

from __future__ import annotations

import jax

__all__ = ["init_distributed", "is_multi_host"]

_initialized = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize JAX's distributed runtime (idempotent).

    With no arguments JAX autodetects a cluster from its environment
    (e.g. SLURM); a plain GPU host has none, so pass the coordinator's
    address, the process count and this process's id. Safe to call on
    single-process setups — it no-ops if initialization fails because
    there is nothing to coordinate.
    """
    global _initialized
    if _initialized:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    except (ValueError, RuntimeError):
        # single-process / no coordinator available: nothing to do
        _initialized = True


def is_multi_host() -> bool:
    return jax.process_count() > 1
