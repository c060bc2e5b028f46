"""Seeded concurrency-bug fixtures for the port's wormsan selftest.

One deliberately buggy scenario per detector.  Each returns after the
sanitizer has had the chance to observe the bug; none of them actually
deadlocks or corrupts anything — the lock-order fixture exercises the
two conflicting orders *sequentially* (the acquisition graph is
order-sensitive, not interleaving-sensitive), and the race fixture
serializes its two writer threads with an event so the schedule is
deterministic while the locksets still come up empty.
"""

from __future__ import annotations

import socket
import threading


def lock_order_cycle() -> None:
    """Acquire A then B, later B then A: an ABBA inversion."""
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    with lock_a:
        with lock_b:
            pass
    with lock_b:
        with lock_a:
            pass


class _Sender:
    """A class whose lock wormsan knows about (watch_class tags it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.sent = 0


def blocking_send_under_lock() -> None:
    """socket.sendall while holding a registry-known lock."""
    from wormhole_tpu_torch import wormsan
    wormsan.watch_class(_Sender, attrs=("sent",), locks=("_lock",))
    a, b = socket.socketpair()
    try:
        s = _Sender()
        with s._lock:
            a.sendall(b"payload")
            s.sent += 1
        b.recv(16)
    finally:
        a.close()
        b.close()


class _Shared:
    """Two threads mutate ``hits`` without ever agreeing on a lock."""

    def __init__(self):
        self.hits = 0


def unguarded_shared_write() -> None:
    from wormhole_tpu_torch import wormsan
    wormsan.watch_class(_Shared, attrs=("hits",))
    obj = _Shared()
    obj.hits = 1  # owner (main thread) write: Exclusive state
    first_done = threading.Event()

    def writer(ev_wait, ev_set):
        if ev_wait is not None:
            ev_wait.wait(5.0)
        obj.hits += 1
        if ev_set is not None:
            ev_set.set()

    t1 = threading.Thread(target=writer, args=(None, first_done),
                          name="san-fixture-w1")
    t2 = threading.Thread(target=writer, args=(first_done, None),
                          name="san-fixture-w2")
    t1.start()
    t2.start()
    t1.join(10.0)
    t2.join(10.0)


ALL = {
    "order": lock_order_cycle,
    "block": blocking_send_under_lock,
    "race": unguarded_shared_write,
}
