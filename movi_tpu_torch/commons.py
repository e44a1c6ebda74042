"""Copy of movi_tpu/commons.py: the port keeps its own, so it imports nothing
of the JAX package.

Timestamped colored logging + build-step progress bars.

Mirrors the reference's commons.hpp:20-44 macros (ERROR/WARNING/INFO/
PROGRESS/SUCCESS/TIMING, timestamped and ANSI-colored) and the
multi-step progress bar of commons.cpp:3-23 (print_progress_bar with
"step i/N" numbering).  Colors and carriage-return bars are emitted
only when stderr is a TTY, so piped logs and tests stay clean.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

_COLORS = {
    "ERROR": "\033[1;31m",
    "WARNING": "\033[1;33m",
    "INFO": "\033[1;36m",
    "PROGRESS": "\033[1;34m",
    "SUCCESS": "\033[1;32m",
    "TIMING": "\033[1;35m",
    "DEBUG": "\033[1;90m",
}
_RESET = "\033[0m"


def _tty() -> bool:
    try:
        return sys.stderr.isatty()
    except Exception:
        return False


def log_msg(level: str, msg: str):
    ts = time.strftime("%H:%M:%S")
    if _tty():
        c = _COLORS.get(level, "")
        sys.stderr.write(f"{c}[{ts}] [{level}]{_RESET} {msg}\n")
    else:
        sys.stderr.write(f"[{ts}] [{level}] {msg}\n")
    sys.stderr.flush()


def info(msg: str):
    log_msg("INFO", msg)


def success(msg: str):
    log_msg("SUCCESS", msg)


def warning(msg: str):
    log_msg("WARNING", msg)


def error(msg: str):
    log_msg("ERROR", msg)


@contextmanager
def timing(label: str):
    """TIMING_MSG equivalent (commons.hpp:31-44): wall-clock a section."""
    t0 = time.time()
    yield
    log_msg("TIMING", f"{label}: {time.time() - t0:.2f}s")


class ProgressBar:
    """print_progress_bar (commons.cpp:3-23): a \\r-refreshed bar with
    build-step numbering.  No-op when stderr is not a TTY."""

    WIDTH = 40

    def __init__(self, total: int, label: str, step: int = 0,
                 total_steps: int = 0):
        self.total = max(int(total), 1)
        self.label = label
        self.step = step
        self.total_steps = total_steps
        self._last = -1
        self._tty = _tty()

    def update(self, count: int):
        if not self._tty:
            return
        pct = int(100 * count / self.total)
        if pct == self._last:
            return
        self._last = pct
        filled = self.WIDTH * count // self.total
        bar = "=" * filled + ">" + " " * (self.WIDTH - filled)
        stepinfo = (f" (step {self.step}/{self.total_steps})"
                    if self.total_steps else "")
        sys.stderr.write(f"\r{_COLORS['PROGRESS']}[{bar}] {pct:3d}%%"
                         .replace("%%", "%")
                         + f"{_RESET} {self.label}{stepinfo}")
        sys.stderr.flush()

    def done(self):
        if self._tty:
            self.update(self.total)
            sys.stderr.write("\n")
            sys.stderr.flush()

    def __enter__(self):
        self.update(0)
        return self

    def __exit__(self, *exc):
        self.done()


def read_progress(count: int, every: int = 1000):
    """Per-1000-read progress line (movi.cpp:343-345)."""
    if count % every == 0 and _tty():
        sys.stderr.write(f"\rProcessed {count} reads ...")
        sys.stderr.flush()
