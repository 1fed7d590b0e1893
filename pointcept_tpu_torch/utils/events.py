"""Scalar event storage with smoothing, and the crash-log writer: the port's
copy of `pointcept_tpu/utils/events.py` (its JSON and console writers are
not carried over: `InformationWriter` writes the port's per-step log).

Parity target: reference `pointcept/utils/events.py` (`EventStorage:296`,
`HistoryBuffer:533`, `ExceptionWriter:599`); the HistoryBuffer/EventStorage
API shape follows that file (itself derived from detectron2, Apache-2.0) —
the implementation here is our own.
"""

from __future__ import annotations

import datetime
import logging
import os
import traceback
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional, Tuple

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    assert _CURRENT_STORAGE_STACK, "get_event_storage() has to be called inside a 'with EventStorage(...)' context!"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """Bounded scalar series with windowed median/mean and a running global
    average (O(1) update via a deque; the bound only limits memory)."""

    def __init__(self, max_length: int = 1000000):
        self._data: Deque[Tuple[float, float]] = deque(maxlen=max_length)
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[float] = None):
        self._data.append((value, self._count if iteration is None else iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def _window(self, window_size: int) -> List[float]:
        n = min(window_size, len(self._data))
        return [v for v, _ in list(self._data)[-n:]]

    def median(self, window_size: int) -> float:
        vals = sorted(self._window(window_size))
        return vals[len(vals) // 2]

    def avg(self, window_size: int) -> float:
        vals = self._window(window_size)
        return sum(vals) / len(vals)

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return list(self._data)


class EventStorage:
    """The user-facing store for scalars/histories during training."""

    def __init__(self, start_iter: int = 0):
        self._history: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, Tuple[float, int]] = {}
        self._iter = start_iter
        self._current_prefix = ""

    def put_scalar(self, name: str, value, smoothing_hint: bool = True):
        name = self._current_prefix + name
        value = float(value)
        self._history[name].update(value, self._iter)
        self._latest_scalars[name] = (value, self._iter)
        existing = self._smoothing_hints.get(name)
        if existing is not None:
            assert existing == smoothing_hint, f"Scalar {name} was put with inconsistent smoothing_hint"
        else:
            self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint)

    def history(self, name: str) -> HistoryBuffer:
        ret = self._history.get(name)
        if ret is None:
            raise KeyError(f"No history metric available for {name}!")
        return ret

    def histories(self):
        return self._history

    def latest(self):
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size: int = 20):
        result = {}
        for k, (v, itr) in self._latest_scalars.items():
            result[k] = (
                self._history[k].median(window_size) if self._smoothing_hints[k] else v,
                itr,
            )
        return result

    def smoothing_hints(self):
        return self._smoothing_hints

    def step(self):
        self._iter += 1

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, val: int):
        self._iter = int(val)

    @contextmanager
    def name_scope(self, name: str):
        old = self._current_prefix
        self._current_prefix = name.rstrip("/") + "/"
        yield
        self._current_prefix = old

    def clear_history(self):
        self._history = defaultdict(HistoryBuffer)

    def reset_history(self, key: str):
        ret = self._history.get(key)
        if ret is None:
            raise KeyError(f"No history metric available for {key}!")
        ret._data.clear()

    def reset_histories(self):
        for v in self._history.values():
            v._data.clear()

    def __enter__(self):
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        assert _CURRENT_STORAGE_STACK[-1] == self
        _CURRENT_STORAGE_STACK.pop()


class ExceptionWriter:
    """Context manager persisting tracebacks to a log file on crash.

    Parity: reference `utils/events.py:599`.
    """

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is None:
            return False
        tb_text = "".join(traceback.format_exception(exc_type, exc_val, exc_tb))
        logging.getLogger("pointcept_tpu_torch").error(tb_text)
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            with open(os.path.join(self.log_dir, f"exception_{stamp}.log"), "w") as f:
                f.write(tb_text)
        return False
