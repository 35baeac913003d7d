"""Build a shared library from sources in the checkout, at first use.

A target is rebuilt when it is missing or older than one of its sources.
Concurrent first uses (test workers, several processes) serialize on a
lock file beside the target.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(ROOT, "build")


def _stale(target: str, sources) -> bool:
    if not os.path.exists(target):
        return True
    built = os.path.getmtime(target)
    return any(os.path.getmtime(s) > built for s in sources)


def build_if_stale(target: str, sources, cmd, timeout: float = 600) -> None:
    """Run `cmd` (argv list) if `target` is missing or stale.  Raises
    RuntimeError with the compiler's output if the build fails."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    with open(target + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(target, sources):
            return
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        if r.returncode != 0 or _stale(target, sources):
            raise RuntimeError(
                f"build of {os.path.basename(target)} failed:\n{r.stdout}{r.stderr}"
            )
