"""Leveled key-value logger (reference libs/log).

The reference logs structured key-value pairs with per-module levels
(libs/log/tm_logger.go + filter.go) and lazy formatting. This maps that
onto a thin layer: Logger.with_fields binds context (module, peer,
height...), level filtering happens before any formatting work, and the
sink is pluggable (stderr text by default; tests capture records).

The port's own copy of `cometbft_tpu/utils/log.py`, unchanged.
"""

from __future__ import annotations

import sys
import threading
import time

DEBUG, INFO, WARN, ERROR, NONE = 10, 20, 30, 40, 100
_NAMES = {DEBUG: "D", INFO: "I", WARN: "W", ERROR: "E"}
_LEVELS = {"debug": DEBUG, "info": INFO, "warn": WARN, "error": ERROR,
           "none": NONE}


class _Config:
    def __init__(self):
        self.default_level = INFO
        self.module_levels: dict[str, int] = {}
        self.sink = self._stderr_sink
        self._lock = threading.Lock()

    @staticmethod
    def _stderr_sink(level: int, msg: str, fields: dict) -> None:
        ts = time.strftime("%H:%M:%S")
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        sys.stderr.write(f"{_NAMES.get(level, '?')}[{ts}] {msg} {kv}\n")


_config = _Config()


def set_level(spec: str) -> None:
    """'info' or per-module 'consensus:debug,p2p:none,*:info'
    (reference log level flag format)."""
    with _config._lock:
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                mod, _, lvl = part.partition(":")
                lv = _LEVELS.get(lvl.strip())
                if lv is None:
                    raise ValueError(f"unknown log level {lvl!r}")
                if mod == "*":
                    _config.default_level = lv
                else:
                    _config.module_levels[mod.strip()] = lv
            else:
                lv = _LEVELS.get(part)
                if lv is None:
                    raise ValueError(f"unknown log level {part!r}")
                _config.default_level = lv


def set_sink(sink) -> None:
    """sink(level, msg, fields) — tests and alternative outputs."""
    _config.sink = sink


class Logger:
    __slots__ = ("module", "fields")

    def __init__(self, module: str, fields: dict | None = None):
        self.module = module
        self.fields = fields or {}

    def with_fields(self, **kw) -> "Logger":
        merged = dict(self.fields)
        merged.update(kw)
        return Logger(self.module, merged)

    def _enabled(self, level: int) -> bool:
        floor = _config.module_levels.get(self.module, _config.default_level)
        return level >= floor

    def _log(self, level: int, msg: str, kw: dict) -> None:
        if not self._enabled(level):
            return  # fields stay unformatted below the floor (lazy)
        fields = {"module": self.module}
        fields.update(self.fields)
        fields.update(kw)
        _config.sink(level, msg, fields)

    def debug(self, msg: str, **kw) -> None:
        self._log(DEBUG, msg, kw)

    def info(self, msg: str, **kw) -> None:
        self._log(INFO, msg, kw)

    def warn(self, msg: str, **kw) -> None:
        self._log(WARN, msg, kw)

    def error(self, msg: str, **kw) -> None:
        self._log(ERROR, msg, kw)


def logger(module: str) -> Logger:
    return Logger(module)
