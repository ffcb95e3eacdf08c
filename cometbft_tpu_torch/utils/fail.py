"""Crash-point injection for crash/recovery testing (twin of
`cometbft_tpu/utils/fail.py`).

Behavior parity: reference internal/fail/fail.go — `fail_point()` is
sprinkled at every dangerous gap in ApplyBlock/finalizeCommit
(reference internal/state/execution.go:251,258,293,301 and the WAL vote
path state.go:843); when the FAIL_TEST_INDEX environment variable is
set to N, the N-th call kills the process, letting tests verify that
WAL + handshake replay recover from a crash at exactly that point.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_call_index = -1


def _target() -> int:
    v = os.environ.get("FAIL_TEST_INDEX")
    return int(v) if v else -1


def fail_point() -> None:
    """Die (exit code 1) if this is the FAIL_TEST_INDEX-th call."""
    global _call_index
    target = _target()
    if target < 0:
        return
    with _lock:
        _call_index += 1
        if _call_index == target:
            os._exit(1)


def reset() -> None:
    global _call_index
    with _lock:
        _call_index = -1
