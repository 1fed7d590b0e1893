"""Wall-clock timer (the port's copy of `pointcept_tpu/utils/timer.py`; parity
target: reference `pointcept/utils/timer.py:8`)."""

from __future__ import annotations

from time import perf_counter
from typing import Optional


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = perf_counter()
        self._paused: Optional[float] = None
        self._total_paused = 0.0
        self._count_start = 1

    def pause(self):
        if self._paused is not None:
            raise ValueError("Trying to pause a Timer that is already paused!")
        self._paused = perf_counter()

    def is_paused(self) -> bool:
        return self._paused is not None

    def resume(self):
        if self._paused is None:
            raise ValueError("Trying to resume a Timer that is not paused!")
        self._total_paused += perf_counter() - self._paused
        self._paused = None
        self._count_start += 1

    def seconds(self) -> float:
        end = self._paused if self._paused is not None else perf_counter()
        return end - self._start - self._total_paused

    def avg_seconds(self) -> float:
        return self.seconds() / self._count_start
