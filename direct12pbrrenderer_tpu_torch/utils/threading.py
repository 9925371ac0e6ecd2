"""Host-side task scheduling (Utils/Thread.h re-expression).

The reference runs tick/render/device threads plus a worker pool
(`TaskScheduler`, Thread.h:104-148) because D3D12 command recording is
host-bound. Here PyTorch queues all device work, so threads serve the same
roles that remain host-bound: asset decode during loading (BC decompression
of many textures) and the console REPL. `TaskQueue`/`ThreadPool` mirror the
reference API (`Schedule` returning futures, by-reference effects, N workers)
and are covered by the same test scenarios as `UnitTest/ThreadPoolTest.cpp`.

The port's copy of the JAX package's `utils/threading.py`. One difference:
`TaskQueue` keeps its tasks in a deque under a condition variable, so an
empty queue is a checked condition rather than a caught `queue.Empty`; the
one handler left hands a task's exception to its future.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future


class TaskQueue:
    """FIFO of packaged tasks; `schedule` returns a Future (TaskQueue::Schedule)."""

    def __init__(self):
        self._q: deque = deque()
        self._ready = threading.Condition()

    def schedule(self, fn, *args, **kwargs) -> Future:
        fut: Future = Future()
        with self._ready:
            self._q.append((fut, fn, args, kwargs))
            self._ready.notify()
        return fut

    def run_one(self, block: bool = True, timeout: float | None = None) -> bool:
        with self._ready:
            if block:
                self._ready.wait_for(lambda: self._q, timeout)
            if not self._q:
                return False
            fut, fn, args, kwargs = self._q.popleft()
        if fut.set_running_or_notify_cancel():
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — propagate via future
                fut.set_exception(e)
        return True

    def empty(self) -> bool:
        return not self._q


class ThreadPool:
    """N worker threads draining a TaskQueue (ThreadPool, Thread.h)."""

    def __init__(self, num_threads: int):
        self.queue = TaskQueue()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"mrtpu-worker-{i}")
            for i in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def schedule(self, fn, *args, **kwargs) -> Future:
        return self.queue.schedule(fn, *args, **kwargs)

    def map(self, fn, items):
        futs = [self.schedule(fn, it) for it in items]
        return [f.result() for f in futs]

    def _worker(self):
        while not self._stop.is_set():
            self.queue.run_one(block=True, timeout=0.1)

    def shutdown(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


_POOL: ThreadPool | None = None


def shared_pool() -> ThreadPool:
    """Process-wide worker pool (TaskScheduler singleton analog)."""
    global _POOL
    if _POOL is None:
        import os

        _POOL = ThreadPool(max(2, (os.cpu_count() or 2)))
    return _POOL
