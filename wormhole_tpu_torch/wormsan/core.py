"""wormsan core: the port's runtime concurrency sanitizer.

The port's copy of the JAX package's sanitizer (``tools/wormsan``), with
the same detectors, knobs, dump format and annotations. It reports
through the port's obs plane, builds its model over
``wormhole_tpu_torch/`` and instruments each model class when its module
is imported (``instrument_classes``), so arming imports no module of the
port that the process would not import anyway.

Three detectors, all driven from monkeypatched synchronization and
blocking primitives (installed once, process-wide, by ``install()``):

* **lock-order** — every wrapped ``threading.Lock``/``RLock`` carries a
  creation site (``file:line``).  Acquiring lock B while holding lock A
  records the directed edge ``site(A) -> site(B)`` in a per-process
  acquisition graph (full stack captured only the first time an edge
  appears).  An edge that closes a cycle is a lock-order inversion: the
  classic ABBA deadlock candidate, reported with the acquisition stacks
  of every edge on the cycle.

* **blocking-under-lock** — ``socket.send/sendall/recv/recv_into``,
  ``os.fsync``, blocking ``queue.Queue.get`` and ``subprocess.Popen``
  entered while the calling thread holds a *registry-known* lock (a lock
  attribute of a class in the shared-state model, i.e. a lock wormlint's
  lock-discipline pass knows guards shared state) stall every other
  thread contending on that lock for a full I/O round trip.

* **lockset-race** — a sampled Eraser-style lockset pass over attribute
  writes of model classes (``tools.wormlint.locks.shared_state_model``;
  the static and dynamic checkers share one model).  Per ``(obj, attr)``
  the detector tracks the Exclusive -> Shared-Modified transition: writes
  stay exclusive to the first thread for free; the first foreign-thread
  write snapshots the candidate lockset C(v) = locks-held-now, later
  writes intersect it, and an empty intersection is a candidate race,
  reported with the stacks of the transition write and the emptying
  write.

Reports drain through the obs plane when available (``san.*`` counters,
flight-recorder dump on the first finding), append JSONL records to
``WH_SAN_DUMP_DIR``, and always accumulate in-process (``findings()``).
A ``# wormsan: allow=<order|block|race>`` comment on the offending
source line suppresses that detector there (read via ``linecache`` at
report time — annotation, like detection, needs no rebuild).

Everything here must be reentrancy-safe: reporting increments metrics
counters whose own (wrapped) locks re-enter the hooks, so every hook
checks a thread-local ``in_san`` guard, and wormsan's internal state is
protected by a raw ``_thread`` lock the wrappers never see.
"""

from __future__ import annotations

import _thread
import atexit
import json
import linecache
import os
import sys
import threading
import time
import traceback
from typing import Any, Iterable, Optional

ENV_ENABLE = "WH_SAN"
ENV_SAMPLE = "WH_SAN_SAMPLE"
ENV_DUMP_DIR = "WH_SAN_DUMP_DIR"

DETECTORS = ("order", "block", "race")

_THIS_FILE = os.path.abspath(__file__)
_THREADING_FILE = os.path.abspath(threading.__file__)

# raw primitives captured before install() rebinds the factories
_raw_alloc = _thread.allocate_lock
_orig_lock_factory = threading.Lock
_orig_rlock_factory = threading.RLock

_state_lock = _raw_alloc()  # guards every module-global below
_installed = False
_sample_n = 1
_dump_path: Optional[str] = None

#: (from_site, to_site) -> formatted stack captured when the edge appeared
_edges: dict[tuple[str, str], str] = {}
#: adjacency view of _edges for cycle walks
_succ: dict[str, set[str]] = {}
_findings: list[dict] = []
_reported_keys: set[str] = set()
#: (id(obj), attr) -> {"owner", "lockset", "stack"}
_race_state: dict[tuple[int, str], dict] = {}
_race_counter = 0
_dumped_flight = False

_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _entered() -> bool:
    """True if already inside a wormsan hook on this thread (reentrancy
    guard: metrics/flight emission takes wrapped locks of its own)."""
    if getattr(_tls, "in_san", False):
        return True
    _tls.in_san = True
    return False


def _leave() -> None:
    _tls.in_san = False


# --- stacks, sites, suppression --------------------------------------------

def _user_frame(skip_files: tuple[str, ...] = ()):
    """Innermost frame outside wormsan/threading (and ``skip_files``)."""
    f = sys._getframe(2)
    skip = (_THIS_FILE, _THREADING_FILE) + skip_files
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) not in skip:
            return f
        f = f.f_back
    return None


def _site_of(frame) -> str:
    if frame is None:
        return "<unknown>:0"
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


def _stack_from(frame) -> str:
    if frame is None:
        return ""
    return "".join(traceback.format_stack(frame))


def _allowed(detector: str, *frames_or_sites) -> bool:
    """``# wormsan: allow=<detector>`` on any involved source line."""
    for fs in frames_or_sites:
        if fs is None:
            continue
        if isinstance(fs, str):
            path, _, lineno = fs.rpartition(":")
            if not path:
                continue
            try:
                line = linecache.getline(path, int(lineno))
            except ValueError:
                continue
        else:
            line = linecache.getline(fs.f_code.co_filename, fs.f_lineno)
        if "# wormsan:" in line and "allow=" in line:
            allowed = line.split("allow=", 1)[1].split()[0]
            if detector in allowed.replace(",", " ").split() \
                    or allowed.startswith("all"):
                return True
    return False


# --- reporting --------------------------------------------------------------

def _registry():
    try:
        from wormhole_tpu_torch.obs.metrics import REGISTRY
        return REGISTRY
    except Exception:
        return None


#: counter increments waiting for a safe emission point
_pending_counts: dict[str, int] = {}
_pending_flight: Optional[str] = None


def _emit_unsafe() -> bool:
    """True when this thread holds a lock internal to the obs plane.
    Emitting a metric (or flight record) there would re-acquire the
    same non-reentrant lock: detectors fire *inside* lock-acquire hooks,
    so a finding triggered by the registry's own lock must not call
    back into the registry synchronously.  ``<wormsan>``-site locks are
    obs-internal by construction: they belong to instruments a hook
    itself created lazily (e.g. the san.* counters), and inc'ing such a
    counter while holding its own lock self-deadlocks."""
    for lk in _held():
        site = lk._site.replace("\\", "/")
        if "/obs/" in site or site.startswith("<wormsan>"):
            return True
    return False


def _bump(name: str) -> None:
    with _state_lock:
        _pending_counts[name] = _pending_counts.get(name, 0) + 1


def _flush_obs() -> None:
    """Drain pending counter bumps and the deferred flight dump, if it
    is safe to touch the obs plane from this thread right now."""
    global _pending_flight
    if _emit_unsafe():
        return
    with _state_lock:
        pend, flight_reason = dict(_pending_counts), _pending_flight
        _pending_counts.clear()
        _pending_flight = None
    REGISTRY = _registry()
    if REGISTRY is not None:
        for name, n in pend.items():
            # literal emit sites: the metric-names checker resolves these
            if name == "san.findings":
                REGISTRY.counter("san.findings").inc(n)
            elif name == "san.order.edges":
                REGISTRY.counter("san.order.edges").inc(n)
            elif name == "san.order.cycles":
                REGISTRY.counter("san.order.cycles").inc(n)
            elif name == "san.block.calls":
                REGISTRY.counter("san.block.calls").inc(n)
            elif name == "san.race.candidates":
                REGISTRY.counter("san.race.candidates").inc(n)
    if flight_reason is not None:
        try:
            from wormhole_tpu_torch.obs import flight
            flight.record_decision("finding", flight_reason)
            flight.dump(flight_reason, force=True)
        except Exception:
            pass


def _report(detector: str, key: str, message: str,
            stacks: dict[str, str]) -> None:
    """Record one deduplicated finding; fan out to obs + dump file."""
    global _dumped_flight, _pending_flight
    finding = {
        "detector": detector, "key": key, "message": message,
        "thread": threading.current_thread().name,
        "pid": os.getpid(), "ts": time.time(), "stacks": stacks,
    }
    with _state_lock:
        if key in _reported_keys:
            return
        _reported_keys.add(key)
        _findings.append(finding)
        first = len(_findings) == 1
    _bump("san.findings")
    _bump({"order": "san.order.cycles", "block": "san.block.calls",
           "race": "san.race.candidates"}[detector])
    if first and not _dumped_flight:
        _dumped_flight = True
        with _state_lock:
            _pending_flight = f"wormsan:{detector}"
    if _dump_path:
        try:
            with open(_dump_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(finding) + "\n")
        except OSError:
            pass
    sys.stderr.write(f"[wormsan:{detector}] {message}\n")
    _flush_obs()


# --- detector 1: lock order -------------------------------------------------

def _cycle_path(frm: str, to: str) -> Optional[list[str]]:
    """DFS: path to -> ... -> frm in the edge graph (so frm->to closes
    a cycle)."""
    stack = [(to, [to])]
    seen = {to}
    while stack:
        node, path = stack.pop()
        if node == frm:
            return path
        for nxt in _succ.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(lock) -> None:
    if _entered():
        return
    try:
        held = _held()
        outer = held[-1] if held else None
        held.append(lock)  # before any emission: _emit_unsafe must see it
        if outer is not None:
            frm, to = outer._site, lock._site
            if frm != to and (frm, to) not in _edges:
                frame = _user_frame()
                stack = _stack_from(frame)
                cycle = None
                with _state_lock:
                    if (frm, to) not in _edges:
                        _edges[(frm, to)] = stack
                        _succ.setdefault(frm, set()).add(to)
                        cycle = _cycle_path(frm, to)
                if cycle is None:
                    _bump("san.order.edges")
                    _flush_obs()
                elif not _allowed("order", frame, frm, to):
                    edges = list(zip(cycle, cycle[1:] + cycle[:1]))
                    stacks = {f"acquire {a} -> {b}": _edges.get((a, b), "")
                              for a, b in edges}
                    ring = " -> ".join(cycle + [cycle[0]])
                    _report(
                        "order",
                        f"order:{'|'.join(sorted(set(cycle)))}",
                        f"lock-order inversion: locks created at {ring} "
                        f"are acquired in conflicting orders (ABBA "
                        f"deadlock candidate)", stacks)
    finally:
        _leave()


def _note_release(lock) -> None:
    if _entered():
        return
    try:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                break
        if _pending_counts or _pending_flight is not None:
            # counts deferred while an obs lock was held drain here, so a
            # snapshot taken later sees them
            _flush_obs()
    finally:
        _leave()


# --- wrapped locks ----------------------------------------------------------

class SanLock:
    """Instrumented ``threading.Lock``."""

    def __init__(self):
        self._inner = _raw_alloc()
        if _entered():
            self._site = "<wormsan>:0"
        else:
            try:
                self._site = _site_of(_user_frame())
            finally:
                _leave()
        self._known: Optional[str] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        _note_release(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()

    def __repr__(self) -> str:
        return f"<SanLock {self._site} known={self._known}>"


class SanRLock:
    """Instrumented ``threading.RLock`` (Condition-compatible)."""

    def __init__(self):
        self._inner = _orig_rlock_factory()
        self._count = 0
        if _entered():
            self._site = "<wormsan>:0"
        else:
            try:
                self._site = _site_of(_user_frame())
            finally:
                _leave()
        self._known: Optional[str] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._count += 1
            if self._count == 1:
                _note_acquire(self)
        return ok

    def release(self) -> None:
        self._count -= 1
        last = self._count == 0
        self._inner.release()
        if last:
            _note_release(self)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol: wait() fully releases / reacquires through these
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        count, self._count = self._count, 0
        state = self._inner._release_save()
        _note_release(self)
        return (state, count)

    def _acquire_restore(self, state) -> None:
        inner_state, count = state
        self._inner._acquire_restore(inner_state)
        self._count = count
        _note_acquire(self)

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()
        self._count = 0

    def _recursion_count(self) -> int:
        return self._count if self._inner._is_owned() else 0

    def __repr__(self) -> str:
        return f"<SanRLock {self._site} known={self._known}>"


# --- detector 2: blocking call under a known lock ---------------------------

def _check_blocking(kind: str, skip_files: tuple[str, ...] = ()) -> None:
    if _entered():
        return
    try:
        known = [lk for lk in _held() if lk._known]
        if not known:
            return
        frame = _user_frame(skip_files)
        lk = known[-1]
        if _allowed("block", frame, lk._site):
            return
        site = _site_of(frame)
        _report(
            "block", f"block:{kind}:{lk._known}:{site}",
            f"blocking {kind} at {site} while holding {lk._known} "
            f"(lock created at {lk._site}) — stalls every contender for "
            f"a full I/O round trip", {"call": _stack_from(frame)})
    finally:
        _leave()


# --- detector 3: sampled lockset race detector ------------------------------

#: class -> (frozenset of watched attrs, frozenset of lock attrs)
_watched: dict[type, tuple[frozenset, frozenset]] = {}


def _race_check(cls: type, obj: Any, attr: str) -> None:
    global _race_counter
    if _entered():
        return
    try:
        _race_counter += 1  # racy increment: sampling, not accounting
        if _sample_n > 1 and _race_counter % _sample_n:
            return
        tid = _thread.get_ident()
        held_sites = frozenset(lk._site for lk in _held())
        key = (id(obj), attr)
        frame0 = _user_frame()
        init_write = frame0 is not None and \
            frame0.f_code.co_name == "__init__"
        with _state_lock:
            st = _race_state.get(key)
            if st is None or init_write:
                # a constructor write claims (or re-claims) ownership:
                # id() reuse after GC would otherwise smear a dead
                # object's sharing history onto a fresh one
                _race_state[key] = {"owner": tid, "lockset": None,
                                    "stack": ""}
                return
            if st["lockset"] is None:
                if tid == st["owner"]:
                    return  # still exclusive to the first thread
                # Exclusive -> Shared-Modified: candidate lockset starts
                # as the locks held by this first foreign write
                st["lockset"] = held_sites
                st["stack"] = _stack_from(frame0)
                if held_sites:
                    return
            else:
                st["lockset"] = st["lockset"] & held_sites
                if st["lockset"]:
                    return
        frame = frame0
        if _allowed("race", frame):
            return
        site = _site_of(frame)
        _report(
            "race", f"race:{cls.__name__}.{attr}",
            f"candidate race on {cls.__name__}.{attr}: written at {site} "
            f"with no lock consistently held across threads",
            {"transition": st["stack"], "write": _stack_from(frame)})
    finally:
        _leave()


def watch_class(cls: type, attrs: Iterable[str],
                locks: Iterable[str] = ()) -> None:
    """Instrument attribute writes on ``cls``: ``attrs`` feed the race
    detector; assignments of wrapped locks to ``locks`` attributes tag
    them registry-known for the blocking detector."""
    if cls in _watched:
        return
    watched = frozenset(attrs)
    lock_attrs = frozenset(locks)
    _watched[cls] = (watched, lock_attrs)
    orig = cls.__setattr__

    def _san_setattr(self, name, value, __orig=orig, __cls=cls):
        if name in lock_attrs and isinstance(value, (SanLock, SanRLock)) \
                and value._known is None:
            value._known = f"{__cls.__name__}.{name}"
        __orig(self, name, value)
        if name in watched:
            _race_check(__cls, self, name)

    cls.__setattr__ = _san_setattr


#: module name -> {class name: model spec}, instrumented on import
_pending_modules: dict[str, dict] = {}
#: "module:Class" of every model class instrumented so far
_instrumented: set[str] = set()
_hook_installed = False


def _instrument_module(mod, classes: dict) -> int:
    """Watch each model class of ``mod``; tag the locks of instances the
    module made at import (a registry, say), which predate the watch."""
    n = 0
    watched = []
    for cls_name, spec in sorted(classes.items()):
        cls = getattr(mod, cls_name, None)
        if cls is None or not isinstance(cls, type):
            continue
        watch_class(cls, spec.get("attrs", ()), spec.get("locks", ()))
        watched.append((cls, spec.get("locks", ())))
        with _state_lock:
            _instrumented.add(f"{mod.__name__}:{cls_name}")
        n += 1
    for value in list(vars(mod).values()):
        for cls, lock_attrs in watched:
            if type(value) is not cls:
                continue
            for name in lock_attrs:
                lk = getattr(value, name, None)
                if isinstance(lk, (SanLock, SanRLock)) and lk._known is None:
                    lk._known = f"{cls.__name__}.{name}"
    return n


class _ImportHook:
    """``sys.meta_path`` finder: a model module not imported yet is
    instrumented right after its body runs. It finds nothing itself; it
    wraps the spec the other finders return."""

    def find_spec(self, name, path=None, target=None):
        classes = _pending_modules.get(name)
        if classes is None:
            return None
        for finder in sys.meta_path:
            find = getattr(finder, "find_spec", None)
            if finder is self or find is None:
                continue
            spec = find(name, path, target)
            if spec is not None:
                break
        else:
            return None
        loader = spec.loader
        if loader is None or not hasattr(loader, "exec_module"):
            return spec
        exec_module = loader.exec_module

        def _exec_and_instrument(module):
            exec_module(module)
            _pending_modules.pop(name, None)
            _instrument_module(module, classes)

        loader.exec_module = _exec_and_instrument
        return spec


def _module_name(path: str) -> str:
    return path[:-3].replace("\\", "/").replace("/", ".") \
        if path.endswith(".py") else path


def instrument_classes(model: Optional[dict] = None) -> int:
    """Instrument the classes of the shared-state model: those of
    modules already imported now, the others when their module is
    imported. Returns the number instrumented by this call."""
    global _hook_installed
    if model is None:
        model = load_model()
    n = 0
    for path, classes in sorted(model.items()):
        modname = _module_name(path)
        mod = sys.modules.get(modname)
        if mod is not None:
            n += _instrument_module(mod, classes)
        else:
            _pending_modules[modname] = classes
    if _pending_modules and not _hook_installed:
        _hook_installed = True
        sys.meta_path.insert(0, _ImportHook())
    return n


def instrumented() -> list[str]:
    """``module:Class`` of every model class instrumented so far."""
    with _state_lock:
        return sorted(_instrumented)


def load_model() -> dict:
    """The static shared-state model, computed by wormlint over the
    port's source tree, its paths relative to the repo root."""
    from tools.wormlint.core import load_files
    from tools.wormlint.locks import shared_state_model
    pkg = os.path.dirname(os.path.dirname(_THIS_FILE))
    repo = os.path.dirname(pkg)
    model = shared_state_model(load_files([pkg]))
    return {os.path.relpath(path, repo).replace(os.sep, "/"): classes
            for path, classes in model.items()}


# --- blocking-call patches --------------------------------------------------

def _patch_blocking() -> None:
    import queue
    import socket
    import subprocess

    sock_file = os.path.abspath(socket.__file__)
    queue_file = os.path.abspath(queue.__file__)
    sub_file = os.path.abspath(subprocess.__file__)

    def wrap(owner, name, kind, skip):
        orig = getattr(owner, name)

        def inner(*a, **kw):
            _check_blocking(kind, skip)
            return orig(*a, **kw)

        inner.__name__ = name
        inner.__wrapped__ = orig
        setattr(owner, name, inner)

    for meth in ("send", "sendall", "recv", "recv_into"):
        wrap(socket.socket, meth, f"socket.{meth}", (sock_file,))
    wrap(os, "fsync", "os.fsync", ())
    wrap(subprocess.Popen, "__init__", "subprocess.Popen", (sub_file,))

    orig_get = queue.Queue.get

    def _san_get(self, block=True, timeout=None):
        if block:
            _check_blocking("queue.get", (queue_file,))
        return orig_get(self, block, timeout)

    _san_get.__wrapped__ = orig_get
    queue.Queue.get = _san_get


# --- install / introspection ------------------------------------------------

def install(instrument: bool = True) -> bool:
    """Patch the process.  Idempotent; returns True if this call did the
    patching.  ``instrument=False`` skips the model-class pass
    (wormhole_tpu_torch/__init__.py loads the model before it patches
    anything, then instruments)."""
    global _installed, _sample_n, _dump_path
    with _state_lock:
        if _installed:
            was = True
        else:
            was = False
            _installed = True
    if was:
        if instrument:
            instrument_classes()
        return False
    try:
        _sample_n = max(1, int(os.environ.get("WH_SAN_SAMPLE", "1") or "1"))
    except ValueError:
        _sample_n = 1
    dump_dir = os.environ.get("WH_SAN_DUMP_DIR", "")
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        _dump_path = os.path.join(dump_dir, f"san-{os.getpid()}.jsonl")
    threading.Lock = SanLock
    threading.RLock = SanRLock
    _patch_blocking()
    atexit.register(_exit_summary)
    if instrument:
        instrument_classes()
    return True


def _exit_summary() -> None:
    """One stderr line of this process's totals as it exits, so each
    role of a launch (its lines prefixed by the launcher) shows what it
    checked: findings by detector, lock-order edges, classes watched."""
    s = summary()
    s.update(findings=sum(s[d] for d in DETECTORS),
             instrumented=len(instrumented()), pid=os.getpid())
    sys.stderr.write(f"[wormsan] exit {json.dumps(s)}\n")


def enabled() -> bool:
    return _installed


def env_enabled() -> bool:
    return os.environ.get(ENV_ENABLE) == "1"


def findings() -> list[dict]:
    _flush_obs()
    with _state_lock:
        return [dict(f) for f in _findings]


def summary() -> dict[str, int]:
    """Finding counts by detector (the serve_lab san-summary line)."""
    _flush_obs()
    out = {d: 0 for d in DETECTORS}
    with _state_lock:
        for f in _findings:
            out[f["detector"]] = out.get(f["detector"], 0) + 1
        out["edges"] = len(_edges)
    return out


def reset() -> None:
    """Drop accumulated findings/edges/race state (patches stay)."""
    global _pending_flight
    with _state_lock:
        _edges.clear()
        _succ.clear()
        _findings.clear()
        _reported_keys.clear()
        _race_state.clear()
        _pending_counts.clear()
        _pending_flight = None
