"""Shared status-polling machinery for the batched (multi-stream) followers.

Same design as the solo engines' ``StatusPolling`` (models/online_core.py):
``is_ready()`` is a free local flag check, while actually READING a status
— even a completed one — is a device→host copy, so reads are rate-limited
and run on a single-slot background worker.  The
followers' per-stream status rows are cumulative, so the newest completed
vector subsumes everything dispatched before it.

Subclasses provide ``_consume(vec)`` (apply one harvested status array to
``self._stopped`` and friends) and may override ``_harvest_thread_name``.

Thread model: ONE feed/dispatch thread; ``stopped``/``last_points`` readers
may poll concurrently (the claim lock serializes the future swap and the
probe/pop/submit sequence).  A background read settled out of order can
transiently report an older ``last_points`` — stop masks are monotone ORs
and unaffected; position readers see at worst one extra poll interval of
staleness.
"""

from __future__ import annotations

import time

import numpy as np


class BatchedStatusPolling:
    _harvest_thread_name = "rtas-batched-harvest"

    def _init_batched_polling(self) -> None:
        self._outstanding: list = []  # in-flight status arrays, oldest first
        self._latest_done = None  # newest completed-but-unread status
        self.poll_min_interval = 2048 / 22050.0  # one feature hop
        self._last_poll_time = 0.0
        # blocking reads run on a worker thread (StatusPolling.async_harvest
        # rationale); bookkeeping stays on the caller thread via the
        # single-slot future.  The claim lock only guards the future swap so
        # a second thread polling stopped-state can't double-drain it.
        import threading

        self._harvest_future = None
        self._harvest_pool = None
        self._drain_lock = threading.Lock()

    def _claim_harvest_future(self, done_only: bool = True):
        """Atomically take the in-flight future if present (and, by default,
        completed); returns it or None if another thread claimed it first."""
        fut = self._harvest_future
        if fut is None or (done_only and not fut.done()):
            return None
        with self._drain_lock:
            if self._harvest_future is not fut:
                return None
            self._harvest_future = None
        return fut

    # -- free local probes ----------------------------------------------

    def _probe(self) -> None:
        """Retire completed in-flight statuses (free local flag checks;
        execution is in-order, so a ready entry subsumes all before it)."""
        q = self._outstanding
        while q and q[0].is_ready():
            self._latest_done = q.pop(0)

    def _in_flight(self) -> int:
        self._probe()
        return len(self._outstanding)

    # -- reads (device→host copies, rate-limited, off-thread) -----------

    def _drain_harvest(self) -> None:
        """Consume a background read that has completed (caller thread)."""
        fut = self._claim_harvest_future()
        if fut is not None:
            self._consume(fut.result())

    def _submit_harvest(self, done) -> None:
        """Hand the blocking status read (a device→host copy) to the worker
        thread.  Callers must only pop ``_latest_done`` when no read is in
        flight — dropping it here would lose the FINAL status irrecoverably
        (stop masks / last_points never surface) when no further dispatch
        arrives."""
        if self._harvest_future is not None:  # would orphan the in-flight
            # read and lose its vector — fail loudly even under python -O
            raise RuntimeError("harvest already in flight; keep the status "
                               "in _latest_done instead")
        if self._harvest_pool is None:
            import concurrent.futures

            self._harvest_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=self._harvest_thread_name
            )
        self._harvest_future = self._harvest_pool.submit(
            lambda d=done: np.asarray(d)
        )

    def _poll_status(self) -> None:
        """Non-blocking refresh: consume a completed background read, retire
        finished launches with free probes, and kick off a rate-limited
        background harvest of the newest completed vector.

        The probe/pop/submit sequence runs under the claim lock: ``stopped``
        / ``last_points`` readers poll concurrently with the feed thread,
        and two threads passing the checks together would double-pop
        ``_latest_done`` (one submitting None) or double-submit."""
        self._drain_harvest()
        with self._drain_lock:
            self._probe()
            if self._latest_done is None or self._stopped.all():
                return
            if self._harvest_future is not None:
                return  # read in flight; the entry is kept for the next poll
            now = time.monotonic()
            if now - self._last_poll_time < self.poll_min_interval:
                return
            self._last_poll_time = now
            done, self._latest_done = self._latest_done, None
            self._submit_harvest(done)

    def _settle_status(self) -> None:
        """Blocking: settle the worker first, then consume the NEWEST
        in-flight status (waiting on the tail subsumes everything before)."""
        fut = self._claim_harvest_future(done_only=False)
        if fut is not None:
            self._consume(fut.result())
        if self._outstanding:
            vec = np.asarray(self._outstanding[-1])
            self._outstanding = []
            self._latest_done = None
            self._consume(vec)
        elif self._latest_done is not None:
            done, self._latest_done = self._latest_done, None
            self._consume(np.asarray(done))
