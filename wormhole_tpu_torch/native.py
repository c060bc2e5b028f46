"""The host data path's core: libsvm parsing, and the pack's stable sorts,
gathers and uniques, on the device the caller names.

The port's counterpart of the JAX package's native core
(wormhole_tpu/native/__init__.py: parse_text, radix_argsort, gather, and
the uniques its pack takes from numpy). It is not a copy of that C++:
- on the CPU (``device`` None or ``"cpu"``) each function is the plain
  route the port had: the Python parser (data/parsers.py parse_libsvm,
  which data/parsers.py parse_text calls there), numpy's stable argsort,
  fancy indexing and np.unique;
- on CUDA the parse is the hand-written kernel chain of csrc/parse.cu
  (``parse_libsvm_kernel``), which converts every token itself, and the
  sorts and uniques are ``torch.sort(stable=True)`` and ``torch.unique``
  on the card (the native core's sort.cc is host C++, not a TPU kernel).
Both routes give the same bytes. Nothing changes route on its own: a CUDA
error propagates, and no call retries on the host.

The torch route of the sorts (``torch_unique``, ``torch_sort_by_key``)
runs on any device, so the CPU tests hold it against numpy. It takes keys
that are non-negative and below 2^63 and computes on them as int64 (torch
sorts uint64 on CUDA only in part); it raises ValueError on any other
key. The port's pack keys are bucket ids.

The card's parser takes bytes in printable ASCII, space, tab, CR and LF
only, and raises ValueError naming the offset of any other byte. The
plain parser follows Python's str.splitlines() and str.split(), which
treat some of those bytes ('\\v', '\\f', '\\x1c'-'\\x1e', non-ASCII
whitespace) as separators; the native C++ parser follows C isspace(). The
card follows neither on such input. Where the plain parser refuses a
token (float() or int() rejects it, or a key lies outside uint64), the
card's raises ValueError naming the token.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.ops import _cuda

_KEY_LIMIT = 1 << 63
_MAX_CHUNK = 1 << 30          # bytes a parse call takes (csrc/parse.cu)
# csrc/parse.cu stats[] slots
_ERR, _NE1, _BAD, _TOKENS, _LINES, _ROWS, _FEATS, EXACT = range(8)


def as_device(device) -> torch.device:
    """None -> the CPU (the plain routes); else the named device."""
    return torch.device("cpu") if device is None else torch.device(device)


# ------------------------------------------------------------------ parse
@dataclasses.dataclass
class ParsedChunk:
    """parse_libsvm_kernel's device arrays, sized by bounds from the byte
    count; ``stats`` holds the counts that cut them, and ``stats[EXACT]``
    the decimals converted by the exact path (csrc/parse.cu)."""

    stats: torch.Tensor    # (8,) int32
    label: torch.Tensor    # (tmax,) f32
    offset: torch.Tensor   # (tmax + 1,) int64
    index: torch.Tensor    # (tmax,) int64, uint64 bits
    value: torch.Tensor    # (tmax,) f32
    start: torch.Tensor    # (tmax,) int32 token starts
    length: torch.Tensor   # (tmax,) int32 token lengths
    bad: torch.Tensor      # (tmax,) uint8: the plain parser refuses it


# csrc/parse.cu's scratch, in wh_parse_libsvm's order: (name, dtype, size
# in bytes (n) or in tokens (t))
_SCRATCH = (("tpos", torch.int32, "n"), ("start", torch.int32, "t"),
            ("len", torch.int32, "t"), ("lno", torch.int32, "t"),
            ("rowc", torch.int32, "t"), ("fcum", torch.int32, "t"),
            ("tflag", torch.uint8, "n"), ("head", torch.uint8, "t"),
            ("keep", torch.uint8, "t"), ("isfeat", torch.uint8, "t"),
            ("bad", torch.uint8, "t"))


def parse_libsvm_kernel(buf: torch.Tensor) -> ParsedChunk:
    """Run csrc/parse.cu over a chunk's bytes on the card: five kernels
    with torch.cumsum scans between them, on the current stream, with no
    host sync. buf: (n,) uint8 CUDA tensor, 0 < n < 2^30."""
    if not buf.is_cuda:
        raise ValueError("parse_libsvm_kernel: buf must be a CUDA tensor "
                         "(parse_text runs the plain parser on the CPU)")
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("parse_libsvm_kernel: buf must be a contiguous 1-D "
                         "uint8 tensor")
    n = buf.numel()
    if not 0 < n < _MAX_CHUNK:
        raise ValueError(f"parse_libsvm_kernel: {n} bytes; a chunk holds 1 "
                         f"to {_MAX_CHUNK - 1}")
    tmax = (n + 1) // 2
    dev = buf.device
    s = {name: torch.empty(n if size == "n" else tmax, dtype=dt, device=dev)
         for name, dt, size in _SCRATCH}
    label = torch.empty(tmax, dtype=torch.float32, device=dev)
    offset = torch.empty(tmax + 1, dtype=torch.int64, device=dev)
    index = torch.empty(tmax, dtype=torch.int64, device=dev)
    value = torch.empty(tmax, dtype=torch.float32, device=dev)
    stats = torch.empty(8, dtype=torch.int32, device=dev)
    lib, st = _cuda.lib("parse"), _cuda.stream(buf)
    ptrs = [buf.data_ptr(), n] + [s[name].data_ptr() for name, _, _ in
                                  _SCRATCH] + [
        t.data_ptr() for t in (label, offset, index, value, stats)]

    def stage(k: int) -> None:
        _cuda.check("parse", lib.wh_parse_libsvm(k, *ptrs, st),
                    f"parse_libsvm stage {k}")

    stage(0)
    torch.cumsum(s["tflag"], 0, dtype=torch.int32, out=s["tpos"])
    stage(1)
    torch.cumsum(s["head"], 0, dtype=torch.int32, out=s["lno"])
    stage(2)
    torch.cumsum(s["keep"], 0, dtype=torch.int32, out=s["rowc"])
    stage(3)
    torch.cumsum(s["isfeat"], 0, dtype=torch.int32, out=s["fcum"])
    stage(4)
    _cuda.count("parse_libsvm")
    return ParsedChunk(stats, label, offset, index, value, s["start"],
                       s["len"], s["bad"])


def upload(raw: bytes, device) -> torch.Tensor:
    """A chunk's bytes on the card, through pinned memory."""
    host = torch.empty(len(raw), dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = np.frombuffer(raw, np.uint8)
    return host.to(device, non_blocking=True)


def parse_libsvm_cuda(data, device) -> RowBlock:
    """Parse a libsvm chunk (str or bytes) on the card: the bytes go over
    once, csrc/parse.cu parses them, the arrays come back to the host."""
    raw = data.encode() if isinstance(data, str) else bytes(data)
    if not raw:
        return RowBlock(label=np.zeros(0, np.float32),
                        offset=np.zeros(1, np.int64),
                        index=np.zeros(0, np.uint64), value=None)
    return finish_parse(parse_libsvm_kernel(upload(raw, device)), raw)


def finish_parse(p: ParsedChunk, raw: bytes) -> RowBlock:
    """Read a ParsedChunk back to the host (one sync for the counts);
    ValueError on a byte outside the alphabet or a token the plain parser
    refuses."""
    st = p.stats.cpu().numpy()
    err = int(st.view(np.uint32)[_ERR])
    if err != 0xFFFFFFFF:
        raise ValueError(
            f"libsvm chunk: byte {err} ({raw[err]:#04x}) is outside "
            f"printable ASCII, space, tab, CR and LF, which the card's "
            f"parser does not take")
    if st[_BAD]:
        t = int(torch.nonzero(p.bad[:int(st[_TOKENS])])[0])
        s, n = int(p.start[t]), int(p.length[t])
        raise ValueError(
            f"libsvm chunk: token {raw[s:s + n].decode()!r} at byte {s} is "
            f"not a label or value float() reads, nor a key int() reads "
            f"in [0, 2^64) ({int(st[_BAD])} such tokens)")
    rows, feats = int(st[_ROWS]), int(st[_FEATS])
    return RowBlock(
        label=p.label[:rows].cpu().numpy(),
        offset=p.offset[:rows + 1].cpu().numpy(),
        index=p.index[:feats].cpu().numpy().view(np.uint64),
        value=p.value[:feats].cpu().numpy() if st[_NE1] else None)


# ------------------------------------------------- sorts, gathers, uniques
def key_tensor(keys, device) -> torch.Tensor:
    """Integer keys as an int64 tensor on `device`; ValueError on a key
    below 0 or at or above 2^63."""
    a = np.ascontiguousarray(keys)
    if a.dtype.kind not in "iu":
        raise ValueError(f"sort keys must be integers, got {a.dtype}")
    if a.size and ((a.dtype.kind == "u" and int(a.max()) >= _KEY_LIMIT)
                   or (a.dtype.kind == "i" and int(a.min()) < 0)):
        raise ValueError("sort keys must be in [0, 2^63): the card sorts "
                         "them as int64")
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype not in (np.int32, np.int64):
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device).to(torch.int64)


def _keys_back(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    """int64 keys from the device, in the input keys' type."""
    a = t.cpu().numpy()
    return a.view(np.uint64) if like.dtype == np.uint64 else a.astype(
        like.dtype, copy=False)


def _bits(a: np.ndarray) -> np.ndarray:
    """An array as a type torch indexes on every device (same bytes)."""
    if a.dtype.kind in "iu" and a.dtype.itemsize in (4, 8):
        return a.view(np.int32 if a.dtype.itemsize == 4 else np.int64)
    return a


def _gather_t(src: np.ndarray, order: torch.Tensor) -> np.ndarray:
    s = torch.from_numpy(_bits(src)).to(order.device)
    return s[order].cpu().numpy().view(src.dtype)


def torch_unique(keys, device):
    """np.unique(keys, return_inverse=True, return_counts=True) by torch
    on `device`: sorted unique keys (the input's type), the inverse and
    the counts (int64)."""
    a = np.asarray(keys)
    u, inv, cnt = torch.unique(key_tensor(a, device), sorted=True,
                               return_inverse=True, return_counts=True)
    return _keys_back(u, a), inv.cpu().numpy(), cnt.cpu().numpy()


def torch_sort_by_key(keys, payloads, device):
    """keys sorted (stable) and each payload in the same order, by torch
    on `device`, in one trip to the device and back."""
    a = np.asarray(keys)
    vals, order = torch.sort(key_tensor(a, device), stable=True)
    return _keys_back(vals, a), [_gather_t(np.ascontiguousarray(p), order)
                                 for p in payloads]


def unique(keys, device=None):
    """Sorted unique keys, the inverse and the counts, as np.unique with
    return_inverse and return_counts: numpy on the CPU, torch elsewhere."""
    dev = as_device(device)
    if dev.type != "cpu":
        return torch_unique(keys, dev)
    return np.unique(np.asarray(keys), return_inverse=True,
                     return_counts=True)


def sort_by_key(keys, payloads, device=None):
    """(keys in stable sorted order, [each payload in that order]): the
    argsort and gathers of the pack, numpy's on the CPU, torch's
    elsewhere."""
    dev = as_device(device)
    if dev.type != "cpu":
        return torch_sort_by_key(keys, payloads, dev)
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    return keys[order], [np.asarray(p)[order] for p in payloads]
