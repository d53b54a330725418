"""Structured timers, the analogue of the reference's thread-aware
`start_timer!` / `end_timer!` / `timed!` macros (`mpc-net/src/utils/timer.rs`).

Port of ``zkmpc_tpu/utils/timer.py``: host wall-clock scopes with nesting,
each thread keeping its own records.  They time host orchestration; a
scope around CUDA work ends when the host returns, not when the card
finishes, so synchronize inside the scope to time device work (or use
``torch.profiler``).
"""

from __future__ import annotations

import contextlib
import threading
import time

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
        _state.records = []
    return _state.stack


@contextlib.contextmanager
def timed(label: str, enabled: bool = True):
    """Time the block; records (depth, label, seconds) and, if
    ``enabled``, prints it indented by depth."""
    stack = _stack()
    depth = len(stack)
    stack.append(label)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        _state.records.append((depth, label, dt))
        if enabled:
            print(f"{'  ' * depth}[timer] {label}: {dt * 1e3:.1f} ms")


def records() -> list:
    """This thread's (depth, label, seconds) records, in order of ending."""
    _stack()
    return list(_state.records)


def reset():
    _stack()
    _state.records = []
