"""Terminal progress bar (ref: python/src/ouster/sdk/util/progress_bar.py)."""

from __future__ import annotations

import sys


def progress_bar(progress: float, width: int = 40,
                 suffix: str = "") -> None:
    """Draw an in-place progress bar for `progress` in [0, 1]."""
    progress = min(max(progress, 0.0), 1.0)
    filled = int(width * progress)
    bar = "#" * filled + "-" * (width - filled)
    sys.stderr.write(f"\r[{bar}] {progress * 100:5.1f}% {suffix}")
    if progress >= 1.0:
        sys.stderr.write("\n")
    sys.stderr.flush()


def progressbar(progress, total, prefix: str = "",
                suffix: str = "") -> None:
    """Percentage progress on one console line
    (ref: util/progress_bar.py:5-22)."""
    if total == 0:
        raise ValueError(
            "Progress cannot be displayed for a total of 0 items.")
    progress = total if progress > total else progress
    percent = round(100 * progress / total, 1)
    filled = int(round(percent * 20 / 100))
    bar = f'[{filled * "#"}{(20 - filled) * "-"}]'
    print(f"{prefix} {bar} {percent}% {suffix}", end="\r")


class ProgressBar:
    """Rate-tracking progress bar with EWMA iteration time and ETA
    (ref: util/progress_bar.py:25-75)."""

    def __init__(self, total: int, alpha: float = 0.05, unit: str = ""):
        import time as _time

        self._time = _time
        self._total = total
        self._alpha = alpha
        self._iteration_time = 0.0
        self._last_time = None
        self._unit = f" {unit}/sec" if unit else "/sec"

    def clear(self) -> None:
        print("\r\033[2K", end="")

    def update(self, progress, prefix: str = "", suffix: str = "") -> None:
        now = self._time.monotonic()
        rate_txt = ""
        if self._last_time is not None:
            dt = now - self._last_time
            if self._iteration_time == 0:
                self._iteration_time = dt
            else:
                self._iteration_time = (self._iteration_time
                                        * (1.0 - self._alpha)
                                        + dt * self._alpha)
            self._iteration_time = max(self._iteration_time, 1e-5)
            rate = 1.0 / self._iteration_time
            remaining = max(0, self._total - progress)
            eta = (f"{remaining / rate:>4.0f} sec remaining"
                   if self._total else "")
            rate_txt = f" {rate:>5.0f}{self._unit} {eta}"
        self._last_time = now
        if self._total:
            progressbar(progress, self._total, prefix,
                        f"{suffix}{rate_txt}")
        else:
            print(f"{prefix} {progress}{rate_txt} {suffix}", end="\r")
