"""The host data path's core: text parsing (libsvm, criteo, criteo_test,
adfea), and the pack's stable sorts, gathers and uniques, on the device
the caller names.

The port's counterpart of the JAX package's native core
(wormhole_tpu/native/__init__.py: parse_text, radix_argsort, gather, and
the uniques its pack takes from numpy). It is not a copy of that C++:
- on the CPU (``device`` None or ``"cpu"``) each function is the plain
  route the port had: the Python parsers (data/parsers.py parse_libsvm,
  parse_criteo, parse_adfea, which data/parsers.py parse_text calls
  there), numpy's stable argsort, fancy indexing and np.unique;
- on CUDA the parse is written by hand for the card: csrc/parse.cu for
  libsvm (``parse_libsvm_kernel``: three launches over tiles of the
  chunk, no library call), csrc/formats.cu for criteo and adfea
  (``parse_criteo_kernel``, ``parse_adfea_kernel``: the same three
  launches over tiles, CityHash64 on the card); each converts every
  token itself. The sorts and uniques are
  ``torch.sort(stable=True)`` and ``torch.unique`` on the card (the
  native core's sort.cc is host C++, not a TPU kernel).
Both routes give the same bytes. Nothing changes route on its own: a CUDA
error propagates, and no call retries on the host.

The torch route of the sorts (``torch_unique``, ``torch_sort_by_key``)
runs on any device, so the CPU tests hold it against numpy. It takes keys
that are non-negative and below 2^63 and computes on them as int64 (torch
sorts uint64 on CUDA only in part); it raises ValueError on any other
key. The port's pack keys are bucket ids; raw adfea keys reach 2^63 and
above and never come here (data/rowblock.py bucketize takes them in
numpy's uint64).

The card's parsers take bytes in printable ASCII, space, tab, CR and LF
only, and raise ValueError naming the offset of any other byte. The
plain parsers follow Python's str.splitlines() and str.split(), which
treat some of those bytes ('\\v', '\\f', '\\x1c'-'\\x1e', non-ASCII
whitespace) as separators; the native C++ parser follows C isspace(). The
card follows neither on such input. Where the plain parser refuses a
token (float() or int() rejects it, or a key lies outside uint64), the
card's raises ValueError naming the token. Where the JAX package's two
parsers (Python and native C++) disagree on edge input, the card follows
the Python parser.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.ops import _cuda

_KEY_LIMIT = 1 << 63
_MAX_CHUNK = 1 << 30          # bytes a parse call takes (csrc/parse.cu)
# the parse kernels' stats[] slots, the last the offset of the first
# refused token
_ERR, _NE1, _BAD, _TOKENS, _LINES, _ROWS, _FEATS, EXACT, _BAD_AT = range(9)


def as_device(device) -> torch.device:
    """None -> the CPU (the plain routes); else the named device."""
    return torch.device("cpu") if device is None else torch.device(device)


# ------------------------------------------------------------------ parse
@dataclasses.dataclass
class ParsedChunk:
    """A parse's device arrays (csrc/parse.cu for libsvm, csrc/formats.cu
    for criteo, criteo_test and adfea), views of one workspace sized by
    bounds from the byte count; ``stats`` holds the counts that cut them,
    ``stats[EXACT]`` the decimals converted by the exact path and
    ``stats[_BAD_AT]`` the offset of the first refused token."""

    fmt: str
    stats: torch.Tensor    # (9,) int32
    label: torch.Tensor    # (tmax,) f32
    offset: torch.Tensor   # (tmax + 1,) int64
    index: torch.Tensor    # (tmax,) int64, uint64 bits
    value: torch.Tensor | None  # (tmax,) f32; libsvm only


# what a refused token is not, by format
_REFUSED = {
    "libsvm": "a label or value float() reads, nor a key int() reads in "
              "[0, 2^64)",
    "criteo": "a label float() reads",
    "criteo_test": "a label float() reads",
    "adfea": "a label float() reads, nor a key: fid:gid of int()s, or an "
             "int() in [0, 2^64)",
}


def check_chunk(buf: torch.Tensor, what: str) -> int:
    """A parse kernel's chunk: a contiguous 1-D uint8 CUDA tensor of 1 to
    2^30 - 1 bytes. Returns its length; ValueError otherwise."""
    if not buf.is_cuda:
        raise ValueError(f"{what}: buf must be a CUDA tensor (parse_text "
                         f"runs the plain parser on the CPU)")
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"{what}: buf must be a contiguous 1-D uint8 "
                         f"tensor")
    n = buf.numel()
    if not 0 < n < _MAX_CHUNK:
        raise ValueError(f"{what}: {n} bytes; a chunk holds 1 to "
                         f"{_MAX_CHUNK - 1}")
    return n


def _carve(ws: torch.Tensor, at: int, count: int, dtype) -> torch.Tensor:
    """count entries of dtype from byte `at` of a uint8 workspace."""
    return ws[at:at + count * dtype.itemsize].view(dtype)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _parse_kernel(buf: torch.Tensor, fmt: str, lib_name: str, sizer: str,
                  entry: str, lead: tuple = (),
                  values: bool = False) -> ParsedChunk:
    """One workspace for a parse kernel over buf (offset, index, label,
    value where `values`, stats, scratch; each from a 16-byte edge), then
    entry(*lead, buf, n, label, offset, index, [value,] stats, scratch,
    stream) on the current stream, with no host sync."""
    what = f"parse_{fmt.removesuffix('_test')}_kernel"
    n = check_chunk(buf, what)
    lib = _cuda.lib(lib_name)
    nbytes, nslots = ctypes.c_int64(0), ctypes.c_int64(0)
    _cuda.check(lib_name, getattr(lib, sizer)(
        n, ctypes.addressof(nbytes), ctypes.addressof(nslots)), sizer)
    tmax = (n + 1) // 2
    sizes = (8 * (tmax + 1), 8 * tmax, 4 * tmax, 4 * tmax * values,
             4 * nslots.value, nbytes.value)
    at = [0]
    for size in sizes:
        at.append(at[-1] + _align16(size))
    ws = torch.empty(at[-1], dtype=torch.uint8, device=buf.device)
    base = ws.data_ptr()
    ptrs = [base + at[2], base + at[0], base + at[1]] + (
        [base + at[3]] if values else [])
    _cuda.check(lib_name, getattr(lib, entry)(
        *lead, buf.data_ptr(), n, *ptrs, base + at[4], base + at[5],
        _cuda.stream(buf)), entry)
    return ParsedChunk(fmt, _carve(ws, at[4], nslots.value, torch.int32),
                       _carve(ws, at[2], tmax, torch.float32),
                       _carve(ws, at[0], tmax + 1, torch.int64),
                       _carve(ws, at[1], tmax, torch.int64),
                       _carve(ws, at[3], tmax, torch.float32) if values
                       else None)


def parse_libsvm_kernel(buf: torch.Tensor) -> ParsedChunk:
    """Run csrc/parse.cu over a chunk's bytes on the card: three launches
    (a count and an emit pass over tiles of the chunk, a scan between
    them), on the current stream, with no host sync. Its arrays are views
    of one workspace. buf: (n,) uint8 CUDA tensor, 0 < n < 2^30."""
    p = _parse_kernel(buf, "libsvm", "parse", "wh_parse_libsvm_scratch",
                      "wh_parse_libsvm", values=True)
    _cuda.count("parse_libsvm")
    return p


def parse_criteo_kernel(buf: torch.Tensor,
                        has_label: bool = True) -> ParsedChunk:
    """Run csrc/formats.cu's criteo parse over a chunk's bytes on the
    card: three launches (a count and an emit pass over tiles of the
    chunk, a scan between them), on the current stream, with no host
    sync. Its arrays are views of one workspace. buf: (n,) uint8 CUDA
    tensor, 0 < n < 2^30. has_label False is criteo_test."""
    p = _parse_kernel(buf, "criteo" if has_label else "criteo_test",
                      "formats", "wh_formats_scratch", "wh_parse_criteo",
                      (int(has_label),))
    _cuda.count("parse_criteo")
    return p


def parse_adfea_kernel(buf: torch.Tensor) -> ParsedChunk:
    """Run csrc/formats.cu's adfea parse over a chunk's bytes on the card,
    as parse_criteo_kernel runs criteo's. buf: (n,) uint8 CUDA tensor,
    0 < n < 2^30."""
    p = _parse_kernel(buf, "adfea", "formats", "wh_formats_scratch",
                      "wh_parse_adfea")
    _cuda.count("parse_adfea")
    return p


def upload(raw: bytes, device) -> torch.Tensor:
    """A chunk's bytes on the card, through pinned memory."""
    host = torch.empty(len(raw), dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = np.frombuffer(raw, np.uint8)
    return host.to(device, non_blocking=True)


def _refused_span(p: ParsedChunk, st: np.ndarray,
                  raw: bytes) -> tuple[int, int]:
    """Byte range of the first refused token (libsvm, adfea) or cell
    (criteo): from its offset in the stats to the next separator."""
    beg = int(st.view(np.uint32)[_BAD_AT])
    ends = b"\t\r\n" if p.fmt in ("criteo", "criteo_test") else b" \t\r\n"
    end = beg
    while end < len(raw) and raw[end] not in ends:
        end += 1
    return beg, end


def finish_parse(p: ParsedChunk, raw: bytes) -> RowBlock:
    """Read a ParsedChunk back to the host (one sync for the counts);
    ValueError on a byte outside the alphabet or a token the plain parser
    refuses."""
    st = p.stats.cpu().numpy()
    err = int(st.view(np.uint32)[_ERR])
    if err != 0xFFFFFFFF:
        raise ValueError(
            f"{p.fmt} chunk: byte {err} ({raw[err]:#04x}) is outside "
            f"printable ASCII, space, tab, CR and LF, which the card's "
            f"parser does not take")
    if st[_BAD]:
        beg, end = _refused_span(p, st, raw)
        raise ValueError(
            f"{p.fmt} chunk: token {raw[beg:end].decode()!r} at byte {beg} "
            f"is not {_REFUSED[p.fmt]} ({int(st[_BAD])} such tokens)")
    rows, feats = int(st[_ROWS]), int(st[_FEATS])
    return RowBlock(
        label=p.label[:rows].cpu().numpy(),
        offset=p.offset[:rows + 1].cpu().numpy(),
        index=p.index[:feats].cpu().numpy().view(np.uint64),
        value=(p.value[:feats].cpu().numpy()
               if p.value is not None and st[_NE1] else None))


def _parse_cuda(data, device, kernel) -> RowBlock:
    """The bytes of a chunk (str or bytes) over to the card once, parsed
    there by `kernel`, the arrays back to the host."""
    raw = data.encode() if isinstance(data, str) else bytes(data)
    if not raw:
        return RowBlock(label=np.zeros(0, np.float32),
                        offset=np.zeros(1, np.int64),
                        index=np.zeros(0, np.uint64), value=None)
    return finish_parse(kernel(upload(raw, device)), raw)


def parse_libsvm_cuda(data, device) -> RowBlock:
    """Parse a libsvm chunk on the card (csrc/parse.cu)."""
    return _parse_cuda(data, device, parse_libsvm_kernel)


def parse_criteo_cuda(data, device, has_label: bool = True) -> RowBlock:
    """Parse a criteo (has_label) or criteo_test chunk on the card
    (csrc/formats.cu, CityHash64 on the card)."""
    return _parse_cuda(data, device,
                       lambda buf: parse_criteo_kernel(buf, has_label))


def parse_adfea_cuda(data, device) -> RowBlock:
    """Parse an adfea chunk on the card (csrc/formats.cu)."""
    return _parse_cuda(data, device, parse_adfea_kernel)


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
