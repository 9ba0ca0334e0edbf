"""Progress watchdog for long training runs (the port's copy of
``lets_face_it_tpu/utils/watchdog.py``).

A run can hang inside a blocking device call (a wedged driver, a lost
device, a deadlocked collective) in a way no Python exception reports; it
then stalls silently and no supervisor restart from the last checkpoint
ever happens. ``ProgressWatchdog`` is a daemon thread that fires
``on_stall`` when no heartbeat arrives for ``timeout_s`` seconds. The
default callback hard-exits the process (``os._exit``: a thread blocked in
native code cannot be interrupted from Python) with ``STALL_EXIT_CODE``, so
that a supervisor (``supervise_train.py``) can tell a stall from a
crash and relaunch with ``--resume_from``.

The watchdog arms on the first beat, so that the first step's one-off costs
(kernel builds, data upload) never count against a timeout sized for
steady-state steps.
"""

from __future__ import annotations

import os
import sys
import threading
import time

# distinct from crash exit codes: "stalled, checkpoint fine, resume"
STALL_EXIT_CODE = 17


def _default_on_stall(idle_s: float, name: str) -> None:
    print(f"watchdog[{name}]: no progress for {idle_s:.0f} s; exiting "
          f"{STALL_EXIT_CODE} so a supervisor can resume from the latest "
          "checkpoint", file=sys.stderr, flush=True)
    os._exit(STALL_EXIT_CODE)


class ProgressWatchdog:
    """Fire ``on_stall(idle_seconds, name)`` when beats stop arriving.

    Unarmed until the first :meth:`beat`. ``stop()`` disarms permanently
    (idempotent). The monitor is a daemon thread, so it never blocks
    interpreter exit.
    """

    def __init__(self, timeout_s: float, on_stall=None, *,
                 name: str = "train", poll_s: float | None = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.name = name
        self._on_stall = on_stall or _default_on_stall
        self._poll_s = poll_s if poll_s is not None else min(5.0, self.timeout_s / 4)
        self._last: float | None = None
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._fired = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"watchdog-{name}")
        self._thread.start()

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()

    def stop(self) -> None:
        self._stopped.set()

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self) -> None:
        while not self._stopped.wait(self._poll_s):
            with self._lock:
                last = self._last
            if last is None:            # not armed yet
                continue
            idle = time.monotonic() - last
            if idle > self.timeout_s:
                self._fired = True
                self._on_stall(idle, self.name)
                return
