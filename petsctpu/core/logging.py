"""Event logging / flop accounting / -log_summary analog.

The reference wraps every interface call in PetscLogEventBegin/End
macros accumulating time, flops, messages and reductions per event
(reference: include/petsclog.h:294; src/sys/logging/plog.c —
PetscLogEventRegister :743, PetscLogView :1264; flops logged at kernel
sites, e.g. SpMV counts 2*nnz - nrows at src/mat/impls/aij/seq/aij.c:1219).

Device execution is async: wall-clock timing is only meaningful
at synchronization points. This module therefore provides:
  * `log_event(name, flops=..)` — context manager that synchronizes on
    exit when `Log.sync` is set, and accrues (count, time, flops);
  * analytic flop/byte models per kernel (we know nnz statically), so
    `log_view()` can print a roofline-annotated summary table;
  * stages (`stage_push/pop`) like -log_summary stages.

The logger is process-global, mirroring the reference's global state.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class EventStats:
    count: int = 0
    time: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    msgs: float = 0.0        # collective-op count (audited)
    msg_bytes: float = 0.0   # collective payload bytes per shard


@dataclass
class _LogState:
    enabled: bool = False
    sync: bool = True
    trace: bool = False
    events: dict = field(default_factory=dict)     # (stage, name) -> EventStats
    stages: list = field(default_factory=lambda: ["Main"])
    t0: float = 0.0


_state = _LogState()


def log_begin(sync: bool = True) -> None:
    """Enable logging (reference: PetscLogBegin plog.c:286)."""
    _state.enabled = True
    _state.sync = sync
    _state.events.clear()
    _state.t0 = time.perf_counter()


def log_enabled() -> bool:
    return _state.enabled


def log_trace(flag: bool = True) -> None:
    """-log_trace analog (plog.c:368): stream every event begin/end for
    hang diagnosis. Implies logging enabled."""
    if flag and not _state.enabled:
        log_begin()
    _state.trace = flag


def stage_push(name: str) -> None:
    _state.stages.append(name)


def stage_pop() -> None:
    if len(_state.stages) > 1:
        _state.stages.pop()


def _sync():
    if _state.sync:
        try:
            import jax
            jax.effects_barrier()
        except Exception:
            pass


@contextmanager
def log_event(name: str, flops: float = 0.0, bytes: float = 0.0):
    """Time a region and accrue flops/bytes under the current stage."""
    if not _state.enabled:
        yield
        return
    _sync()
    t = time.perf_counter()
    if _state.trace:
        print(f"Event begin: {name} [{_state.stages[-1]}] "
              f"t={t - _state.t0:.6f}", flush=True)
    yield
    _sync()
    dt = time.perf_counter() - t
    if _state.trace:
        print(f"Event end:   {name} [{_state.stages[-1]}] dt={dt:.6f}",
              flush=True)
    key = (_state.stages[-1], name)
    ev = _state.events.setdefault(key, EventStats())
    ev.count += 1
    ev.time += dt
    ev.flops += flops
    ev.bytes += bytes


def log_flops(name: str, flops: float, bytes: float = 0.0) -> None:
    """Accrue flops without timing (for fused regions)."""
    if not _state.enabled:
        return
    key = (_state.stages[-1], name)
    ev = _state.events.setdefault(key, EventStats())
    ev.flops += flops
    ev.bytes += bytes


def log_comm(name: str, msgs: float, msg_bytes: float = 0.0) -> None:
    """Accrue collective counts/volume under an event — the
    reference's Mess/MessLen/Reductions ledger (petsclog.h:294; the
    columns PetscLogView prints at plog.c:1264). Sources: the
    compile-time jaxpr audit (core/commaudit) times the iteration
    count, or static halo-plan metadata."""
    if not _state.enabled:
        return
    key = (_state.stages[-1], name)
    ev = _state.events.setdefault(key, EventStats())
    ev.msgs += msgs
    ev.msg_bytes += msg_bytes


def log_view() -> str:
    """Format a -log_summary-style table (reference: PetscLogView plog.c:1264)."""
    total = time.perf_counter() - _state.t0
    lines = []
    lines.append("-" * 105)
    lines.append("petsctpu performance summary (-log_summary analog)")
    lines.append(f"Total wall time: {total:.4e} s")
    lines.append("-" * 105)
    lines.append(f"{'Stage/Event':34s} {'Count':>7s} {'Time (s)':>11s} "
                 f"{'%T':>5s} {'GFlop':>9s} {'GF/s':>8s} {'GB/s':>8s} "
                 f"{'Mess':>7s} {'MessMB':>8s}")
    lines.append("-" * 105)
    by_stage: dict = {}
    for (stage, name), ev in _state.events.items():
        by_stage.setdefault(stage, []).append((name, ev))
    for stage, rows in by_stage.items():
        lines.append(f"--- stage: {stage}")
        for name, ev in sorted(rows, key=lambda r: -r[1].time):
            gf = ev.flops / 1e9
            gfs = gf / ev.time if ev.time > 0 else 0.0
            gbs = ev.bytes / 1e9 / ev.time if ev.time > 0 else 0.0
            pct = 100.0 * ev.time / total if total > 0 else 0.0
            lines.append(f"{name:34s} {ev.count:7d} {ev.time:11.4e} "
                         f"{pct:5.1f} {gf:9.3f} {gfs:8.2f} {gbs:8.2f} "
                         f"{ev.msgs:7.0f} {ev.msg_bytes/1e6:8.3f}")
    lines.append("-" * 105)
    return "\n".join(lines)


# ---- analytic flop models (static nnz known at plan time) -------------------
def spmv_flops(nnz: int, nrows_nonzero: int = None) -> float:
    """Reference convention: 2*nnz - nonzero_rows (aij.c:1219)."""
    if nrows_nonzero is None:
        return 2.0 * nnz
    return 2.0 * nnz - nrows_nonzero


def dot_flops(n: int) -> float:
    return 2.0 * n


def axpy_flops(n: int) -> float:
    return 2.0 * n


# ---------------------------------------------------------------------------
# -info verbose channel (PetscInfo, src/sys/info/verboseinfo.c)
# ---------------------------------------------------------------------------
_INFO = False


def info_on(flag: bool = True) -> None:
    """PetscInfoAllow analog: enable the -info verbose stream."""
    global _INFO
    _INFO = bool(flag)


def info_enabled() -> bool:
    return _INFO


def petsc_info(func: str, msg: str) -> None:
    """PetscInfo analog: '[0] Func(): message' lines documenting
    internal decisions (format selection, level sizes, plan stats) —
    the reference's -info channel (verboseinfo.c; e.g. 'Stash has %D
    entries' mpiaij.c:649). Host-side only: these fire at plan/setup
    time, never inside jit."""
    if _INFO:
        import sys
        print(f"[0] {func}(): {msg}", file=sys.stderr, flush=True)
