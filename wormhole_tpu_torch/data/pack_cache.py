"""Packed-batch epoch cache: skip the parse and the pack from epoch 2 on.

The port's copy of the JAX package's data/pack_cache.py. A learner's
prepared batch is a pure function of the batch's bytes and the pack's
parameters, so prepared batches are stored under a content and
configuration fingerprint and replayed on later passes (or Lloyd
iterations): the loaders feed the device from memory, or from mmap'd
disk, instead of parsing and packing again.

Two tiers:

- a memory tier holding the prepared objects themselves, LRU-evicted
  against a byte budget (``WH_PACK_CACHE_MB``, default 512). Consumers
  treat prepared batches as read-only (they only copy them to the
  device), so handing back the same object replays the same bytes. On
  the CPU ``torch.from_numpy(a).to("cpu")`` is a view of ``a``, so a
  step must never write into its staged arguments;
- an optional disk tier (``WH_PACK_CACHE_DIR``): each entry one file,
  written atomically (temp file + ``os.replace``) and loaded through
  ``np.memmap``, so a cache shared across runs never serves a half-written
  entry and costs no memory until a batch is used. A damaged or truncated
  entry counts as a miss and is deleted. Entries are mapped copy-on-write
  (``mode="c"``): the arrays are writable, as ``torch.from_numpy`` wants,
  and a write never reaches the file.

Leaves are numpy arrays and torch tensors; the memory tier keeps them as
they are, the disk tier writes a host copy and gives numpy back (the
consumer stages it anyway). The header pickles the batch's skeleton with
the port's own dataclasses (SortedCOO, TileCOO, DeviceBatch, ...), and
the learners' keys carry the port's own tokens and pack versions: an
entry of the JAX package's cache neither loads here nor shares a key with
the port's, and the reverse holds too. Only entries this program wrote
are unpickled: the directory is the run's own.

Keying: callers build keys with :func:`fingerprint` from the file part's
identity and :func:`file_stamp`, the batch index within the part, the
pack parameters and the learner's pack version. A learner whose pack
cannot be replayed (DiFacto's compact train pack, whose admission reads
and moves the count mirror) declines by returning None from its
``pack_cache_token``, and the loader packs as before.

Off by default: with no knob set, :func:`from_env` gives None, no cache
object exists and :func:`iter_part_cached` is the plain loop.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import logging
import os
import pickle
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from wormhole_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger(__name__)

#: bump when the on-disk entry format or the flatten skeleton changes
FORMAT_VERSION = 1

_MAGIC = b"WHPK%d\n" % FORMAT_VERSION

_HITS = REGISTRY.counter("pack_cache.hits")
_MISSES = REGISTRY.counter("pack_cache.misses")
_DISK_HITS = REGISTRY.counter("pack_cache.disk_hits")
_EVICTS = REGISTRY.counter("pack_cache.evictions")
_CORRUPT = REGISTRY.counter("pack_cache.corrupt")
_BYTES = REGISTRY.gauge("pack_cache.bytes")


def fingerprint(*parts) -> str:
    """Stable hex digest of a tuple of primitives and nested tuples;
    callers include every input that changes the pack."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=16)
    return h.hexdigest()


def file_stamp(path: str) -> tuple:
    """(size, mtime_ns) of a file, so an overwritten input never serves
    stale packs; (None, None) for a missing file."""
    try:
        st = os.stat(path)
        return (st.st_size, st.st_mtime_ns)
    except OSError:
        return (None, None)


# ------------------------------------------------------- pytree plumbing
# Prepared batches are nested tuples and dataclasses of numpy arrays (or
# torch tensors) plus static metadata. _flatten pulls the array leaves
# out and leaves a picklable skeleton; _unflatten rebuilds the object
# around a fresh (possibly mmap-backed) leaf list.

_ARR = "__whpk_arr__"


def _flatten(obj, leaves: list) -> Any:
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        leaves.append(obj)
        return (_ARR, len(leaves) - 1)
    if obj is None or isinstance(obj, (bool, int, float, str, bytes,
                                       np.integer, np.floating)):
        return obj
    if isinstance(obj, tuple):
        return ("__tuple__", [_flatten(x, leaves) for x in obj])
    if isinstance(obj, list):
        return ("__list__", [_flatten(x, leaves) for x in obj])
    if isinstance(obj, dict):
        return ("__dict__", [(k, _flatten(v, leaves))
                             for k, v in obj.items()])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ("__dc__", type(obj),
                [(f.name, _flatten(getattr(obj, f.name), leaves))
                 for f in dataclasses.fields(obj)])
    raise TypeError(f"pack_cache cannot serialize {type(obj)!r}")


def _unflatten(skel, leaves: list) -> Any:
    if isinstance(skel, tuple) and skel and skel[0] == _ARR:
        return leaves[skel[1]]
    if isinstance(skel, tuple) and skel and skel[0] == "__tuple__":
        return tuple(_unflatten(x, leaves) for x in skel[1])
    if isinstance(skel, tuple) and skel and skel[0] == "__list__":
        return [_unflatten(x, leaves) for x in skel[1]]
    if isinstance(skel, tuple) and skel and skel[0] == "__dict__":
        return {k: _unflatten(v, leaves) for k, v in skel[1]}
    if isinstance(skel, tuple) and skel and skel[0] == "__dc__":
        _, cls, fields = skel
        return cls(**{k: _unflatten(v, leaves) for k, v in fields})
    return skel


def _leaf_bytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return a.nbytes


def nbytes_of(obj) -> int:
    """Footprint of a prepared batch: the array leaves plus a small
    per-entry constant for the skeleton."""
    leaves: list = []
    _flatten(obj, leaves)
    return sum(_leaf_bytes(a) for a in leaves) + 512


# ------------------------------------------------------------- disk tier
def _host(a) -> np.ndarray:
    """A leaf as a contiguous host array (a tensor is copied to the
    host; a dtype numpy lacks, bfloat16, raises TypeError)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a)


def _encode(obj) -> bytes:
    leaves: list = []
    skel = _flatten(obj, leaves)
    leaves = [_host(a) for a in leaves]
    manifest = []
    off = 0
    for a in leaves:
        manifest.append((str(a.dtype), a.shape, off, a.nbytes))
        off += a.nbytes
    head = pickle.dumps({"skel": skel, "manifest": manifest,
                         "data_bytes": off})
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(len(head).to_bytes(8, "little"))
    buf.write(head)
    for a in leaves:
        buf.write(a.tobytes())
    return buf.getvalue()


def _decode_file(path: str):
    """Load one entry; raises on any structural damage (magic, header
    pickle, or file-size mismatch): the caller counts that as a miss and
    deletes the file, so the batch is packed again."""
    with open(path, "rb") as fh:
        magic = fh.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"bad pack-cache magic in {path}")
        head_len = int.from_bytes(fh.read(8), "little")
        if head_len <= 0 or head_len > 1 << 30:
            raise ValueError("implausible pack-cache header length")
        head = pickle.loads(fh.read(head_len))
        data_start = len(_MAGIC) + 8 + head_len
    expect = data_start + head["data_bytes"]
    if os.path.getsize(path) != expect:
        raise ValueError(f"truncated pack-cache entry {path}")
    leaves = []
    for dtype, shape, off, nb in head["manifest"]:
        dtype, shape = np.dtype(dtype), tuple(shape)
        leaves.append(np.memmap(path, dtype=dtype, mode="c",
                                offset=data_start + off, shape=shape)
                      if nb else np.empty(shape, dtype))
    return _unflatten(head["skel"], leaves)


class PackCache:
    """Two-tier packed-batch cache. Thread-safe: loader threads get and
    put concurrently; the lock covers only the memory index, disk I/O runs
    outside it (atomic temp + rename makes concurrent writers of one key
    harmless: the last rename wins, with the same bytes)."""

    def __init__(self, mem_bytes: int = 512 << 20,
                 disk_dir: Optional[str] = None):
        self.mem_bytes = int(mem_bytes)
        self.disk_dir = disk_dir
        self._lock = threading.Lock()
        self._mem: OrderedDict[str, tuple[Any, int]] = OrderedDict()
        self._mem_used = 0
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)

    def get(self, key: str):
        """The cached object or None. Memory first, then disk (a disk hit
        is promoted into the memory tier)."""
        with self._lock:
            got = self._mem.get(key)
            if got is not None:
                self._mem.move_to_end(key)
                self.hits += 1
                _HITS.inc()
                return got[0]
        if self.disk_dir:
            path = self._path(key)
            try:
                if os.path.exists(path):
                    obj = _decode_file(path)
                    with self._lock:
                        self.hits += 1
                        self.disk_hits += 1
                    _HITS.inc()
                    _DISK_HITS.inc()
                    self._mem_insert(key, obj, nbytes_of(obj))
                    return obj
            except Exception as e:  # any damage: a logged miss
                _CORRUPT.inc()
                log.warning("pack cache: dropping corrupt entry %s (%s); "
                            "the batch will be repacked", path, e)
                try:
                    os.remove(path)
                except OSError:
                    pass
        with self._lock:
            self.misses += 1
        _MISSES.inc()
        return None

    def put(self, key: str, obj) -> bool:
        """Insert into both tiers. Returns False, caching nothing, if the
        object holds leaves the flattener does not understand: callers
        then skip caching that batch."""
        try:
            nb = nbytes_of(obj)
        except TypeError as e:
            log.warning("pack cache: uncacheable batch (%s)", e)
            return False
        self._mem_insert(key, obj, nb)
        if self.disk_dir:
            path = self._path(key)
            if not os.path.exists(path):
                try:
                    blob = _encode(obj)
                    fd, tmp = tempfile.mkstemp(dir=self.disk_dir,
                                               prefix=".whpk_tmp_")
                    try:
                        with os.fdopen(fd, "wb") as fh:
                            fh.write(blob)
                        os.replace(tmp, path)  # atomic publish
                    except BaseException:
                        try:
                            os.remove(tmp)
                        except OSError:
                            pass
                        raise
                except (OSError, TypeError) as e:
                    log.warning("pack cache: disk spill failed for %s "
                                "(%s)", key, e)
        return True

    def _mem_insert(self, key: str, obj, nb: int) -> None:
        if nb > self.mem_bytes:
            return  # larger than the whole budget: disk tier only
        with self._lock:
            old = self._mem.pop(key, None)
            if old is not None:
                self._mem_used -= old[1]
            self._mem[key] = (obj, nb)
            self._mem_used += nb
            while self._mem_used > self.mem_bytes and self._mem:
                _, (_, enb) = self._mem.popitem(last=False)
                self._mem_used -= enb
                _EVICTS.inc()
            _BYTES.set(self._mem_used)

    def _path(self, key: str) -> str:
        return os.path.join(self.disk_dir, f"{key}.whpack")

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "disk_hits": self.disk_hits,
                "hit_rate": self.hits / total if total else 0.0,
                "mem_bytes": self._mem_used,
                "mem_entries": len(self._mem),
            }

    def clear_memory(self) -> None:
        with self._lock:
            self._mem.clear()
            self._mem_used = 0
            _BYTES.set(0)


def from_env() -> Optional[PackCache]:
    """The run's cache per environment knobs, or None (the default: no
    object, no change to the loader path). WH_PACK_CACHE=1 turns on the
    memory tier; WH_PACK_CACHE_DIR turns on (and implies) the disk tier;
    WH_PACK_CACHE_MB sizes the memory tier (default 512)."""
    disk = os.environ.get("WH_PACK_CACHE_DIR") or None
    on = os.environ.get("WH_PACK_CACHE", "").lower() not in (
        "", "0", "false", "off")
    if not on and not disk:
        return None
    mem_mb = int(os.environ.get("WH_PACK_CACHE_MB", "512"))
    return PackCache(mem_bytes=mem_mb << 20, disk_dir=disk)


# ---------------------------------------------------- whole-part replay
def iter_part_cached(cache: Optional[PackCache], part_key,
                     raw_iter_fn: Callable[[], Iterable],
                     prepare_fn: Callable[[Any], Any]) -> Iterator:
    """Iterate one file part's prepared batches through the cache.

    ``part_key`` identifies the part and the whole pack configuration;
    batch ``i`` lives under fingerprint(part_key, i) and a count entry
    under fingerprint(part_key, "n") says how many batches the part
    yields. On a warm pass the part is replayed from the cache whole: the
    source file is never opened, no parse and no pack run.

    An entry evicted (or found damaged) mid-replay reopens the source and
    skips the batches already served (parsed again, not packed again nor
    yielded), and filling resumes from the gap.

    With ``cache`` or ``part_key`` None this is the plain loop."""
    if cache is None or part_key is None:
        for blk in raw_iter_fn():
            yield prepare_fn(blk)
        return
    start = 0
    n = cache.get(fingerprint(part_key, "n"))
    if n is not None:
        for i in range(int(n)):
            b = cache.get(fingerprint(part_key, i))
            if b is None:
                break
            yield b
            start = i + 1
        else:
            return
    count = start
    for i, blk in enumerate(raw_iter_fn()):
        if i < start:
            continue  # served from the cache before the gap
        b = prepare_fn(blk)
        cache.put(fingerprint(part_key, i), b)
        count = i + 1
        yield b
    cache.put(fingerprint(part_key, "n"), count)
