"""Kernel launch counters that stay exact when several threads step.

Each kernel wrapper counts a launch with `bump`: the module's total
(contact_solver.LAUNCHES, particles_kernels.K3_LAUNCHES, ...) is raised
under one lock, so shards stepping in several threads lose no count, and
every counter set that the calling thread has open (`counting`) is raised
by as much. A step function opens its stats' `launches` for the length of
a call (world.Step, batch.BatchedStep), so each shard's stats count the
launches of its own thread only, while the module totals sum every
launch of every thread.
"""

from __future__ import annotations

import contextlib
import threading

_LOCK = threading.Lock()
_OPEN = threading.local()


def bump(namespace: dict, *names: str, by: int = 1) -> None:
    """Add `by` to each counter `names` of a module (its globals()) and to
    every counter set this thread has open, there under the key
    "<module>.<name>" (as "contact_solver.BATCHED_LAUNCHES")."""
    with _LOCK:
        for name in names:
            namespace[name] += by
    sets = getattr(_OPEN, "sets", ())
    if sets:
        module = namespace["__name__"].rsplit(".", 1)[-1]
        for counts in sets:
            for name in names:
                key = f"{module}.{name}"
                counts[key] = counts.get(key, 0) + by


@contextlib.contextmanager
def counting(counts: dict):
    """Count this thread's launches into `counts` ({counter name: n})
    inside the block, besides the module totals and any set opened
    around it."""
    sets = getattr(_OPEN, "sets", ())
    _OPEN.sets = sets + (counts,)
    try:
        yield counts
    finally:
        _OPEN.sets = sets
