"""Shared TCP plumbing for the runtime control/data planes.

The port's copy of the JAX package's runtime/net.py, renamed to this
package and sharing nothing with it: its frames are the JAX package's
byte for byte, so either package's peers talk to the other's.

Connection establishment retries with backoff (the launcher spawns all
node processes concurrently, so clients routinely race ahead of a
server's bind); once a connection exists, request/response failures are
NOT retried here — the ops they carry (barrier entry, part assignment)
are not idempotent, so replay policy belongs to the caller. (The PS
data plane layers a fenced, idempotent retry on top: PSClient stamps
pushes with per-sender sequence numbers the servers deduplicate, which
is what makes ITS replay safe — see runtime/ps_server.py.)

This module also owns the PS wire format. Frame = 4-byte big-endian
header length | JSON header | raw payload. header = {"op": str, ...meta,
"arrays": [{"name", "shape", "enc", "scale", "nbytes"}, ...]}; payload =
buffers concatenated in array order. Integer arrays (sparse-push/pull
row indices) ride the same frame with enc="i32"/"i64" — under the
negotiated bshuf mode a sorted 1-D index array additionally ships
delta-encoded ("dlt": 1 — first value + gaps, cumsum on decode), which
zeroes its high byte planes for the shuffle; float payloads
may additionally ship quantized (enc="bf16"/"int8"/"int8r"/"int4"/
"int4r" — the r-suffixed forms carry per-row f32 scales appended to the
code bytes; int4 packs two biased nibbles per byte). "comp": "zlib" (or
"bshuf+zlib", the byte-plane-shuffled form) marks a compressed buffer
("nbytes" is then the compressed size, "rawbytes" the original). Key-list caching (the reference's KEY_CACHING
filter) rides the JSON header as `key_digest()` fingerprints — a frame
whose digest the receiver has cached omits the index array entirely
(runtime/ps_server.py owns the cache + miss/full-resend protocol).

Decoded arrays are zero-copy views over the received buffer and may be
READ-ONLY (raw/i32/i64 encodings); callers that mutate a decoded array
in place must copy it first.

Fault injection (runtime/faults.py) hooks frame send/recv; the guards
are module-level None checks so an unfaulted process pays nothing.
Wire accounting (frames/bytes in+out, encode/decode latency, connect
retries) lands in the process-wide metrics registry (wormhole_tpu_torch/obs)
via handles cached at import.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import sys
import struct
import threading
import time
import zlib
from typing import Optional

import numpy as np

from wormhole_tpu_torch.obs import flight as _flight
from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.obs import trace as _trace
from wormhole_tpu_torch.runtime import faults
from wormhole_tpu_torch.runtime import overload as _overload
from wormhole_tpu_torch.runtime import retry as _retry

_COMPRESS_MIN = 512  # don't bother compressing tiny buffers

# wire codec v2: value encodings a peer may negotiate (WH_WIRE). "raw"
# ships f32; the rest quantize float payloads (never index arrays).
WIRE_ENCODINGS = ("raw", "bf16", "int8", "int4")
# frame compression modes (WH_WIRE_COMP / WH_NET_COMPRESS): "bshuf"
# byte-plane-shuffles multi-byte payloads before zlib-1 so the
# same-significance bytes (exponents especially) group into long runs
WIRE_COMP_MODES = ("", "zlib", "bshuf")

# Central declaration table for every top-level header key the frame
# protocol (and the scheduler's newline-JSON RPC) carries, the same
# table as the JAX package's, whose lint checks every header site
# against it. Per-array metadata (the entries of the
# "arrays" list: name/shape/enc/scale/nbytes/comp/rawbytes/dlt/gs/goff)
# is the codec's own and is not declared here.
# fmt: off
HEADER_KEYS: dict[str, str] = {
    # -- every frame / every plane
    "op": "request verb (push/pull/fetch/score/hello/bsp_step/...)",
    "arrays": "per-payload array metadata list (codec-owned fields)",
    "sender": "stable client identity for seq dedup and reply caching",
    "seq": "per-sender request sequence number (exactly-once retries)",
    "error": "reply-side failure message; absence means success",
    "ok": "reply-side success marker",
    "tctx": "sampled request-trace context (obs/trace.py bind_wire)",
    "dl": "relative deadline budget in seconds, stamped at send",
    "dl_mono": "receiver-anchored absolute deadline (overload.arm)",
    "shed": "reply marker: the deadline expired before dispatch",
    "busy": "reply marker: the admission gate bounced this frame",
    "retry_ms": "suggested client backoff attached to a busy reply",
    # -- hello negotiation (PS + serving)
    "net_compress": "both ends agree to zlib frame compression",
    "wire": "negotiated value encoding (WIRE_ENCODINGS) for payloads",
    "wire_comp": "negotiated frame compression mode (WIRE_COMP_MODES)",
    "wire_ef": "client uses error-feedback residuals on quantized pushes",
    "comp_reply": "server will compress its replies to this client",
    "world": "shard-group size echoed in hello (config cross-check)",
    # -- PS data plane (runtime/ps_server.py)
    "epoch": "server restore epoch stamped on every PS reply",
    "full_rows": "table name -> row count map (init / hello replies)",
    "specs": "table name -> dtype/shape spec map (init_spec)",
    "derived": "derived-table expressions shipped with init_spec",
    "since": "client clock for incremental pulls",
    "skip": "pull reply: rows unchanged since `since`, payload omitted",
    "clock": "server logical clock stamped on pull replies",
    "last_seq": "highest per-sender push seq the server has applied",
    "dup": "push reply: seq already applied, delta dropped (dedup)",
    "kc": "client requests key-list digest caching for this push",
    "kdig": "group -> key-list digest map (key cache probe)",
    "kfull": "group -> digest map acknowledging a full key resend",
    "known": "digest probe reply: all digests matched the cache",
    "need": "digest probe reply: groups needing a full key resend",
    "need_keys": "push reply: digest missed, client must resend keys",
    "base": "snapshot base path for save/load ops",
    "iter": "snapshot iteration label for save/load ops",
    # -- serving plane (serving/server.py, serving/router.py)
    "version": "model snapshot version stamped on serving replies",
    "kind": "score-op model kind (linear/difacto)",
    "rows": "live row count of a score round's fold target",
    "tables": "table names requested by a fetch",
    "rep": "fetch wants replicated (full) tables, not range slices",
    "queue_s": "shard-side recv-to-dispatch queue wait (stage attribution)",
    "served_s": "shard-side handler service time (stage attribution)",
    "degraded": "reply served under degraded mode (bounded staleness)",
    "threshold": "difacto admission threshold for the score op",
    "vb": "difacto V-table hash buckets for the score op",
    "l1_shrk": "difacto l1-shrink admission flag for the score op",
    # -- BSP collective plane (runtime/allreduce.py)
    "gen": "group membership generation (tracker-owned fencing)",
    "ver": "BSP checkpoint version of the collective",
    "t": "ring step index within one allreduce round",
    "src": "sending rank of a bsp_step frame",
    "hit": "bsp_fetch reply: the cached reduced result was present",
    "next": "bsp_fetch reply: (ver, seq) the peer advanced to",
    # -- scheduler control plane (runtime/tracker.py, newline-JSON RPC)
    "inc": "scheduler incarnation stamped on every reply (restart fence)",
    "fgen": "flight-recorder trigger generation piggybacked on replies",
    "fwhy": "flight-recorder trigger reason piggybacked on replies",
    "node": "reporting node's name (heartbeats, registrations)",
    "rank": "role-group rank of the registering node",
    "uri": "RPC endpoint the registering node listens on",
    "part_id": "workload part id assigned by get / finished by finish",
    "mepoch": "membership epoch stamped on part grants and completions",
    "metrics": "heartbeat-piggybacked metrics snapshot",
    "format": "workload pattern format argument of add_local",
    "files": "workload file list argument of add_local",
    "progress": "progress blob attached to a finish/report op",
    "data": "blob payload of blob_put",
    "key": "blob name of blob_put/blob_get/blob_del",
    "name": "barrier name of a barrier/barrier_wait op",
    "target": "desired worker count in an elastic reply",
    "history": "metrics verb: client wants the telemetry ring, not a spot",
    "slo": "metrics verb: client wants SLO burn judgments included",
    "reason": "flight-trigger op: why the cluster dump fired",
}
# fmt: on

# handles cached at import: per-frame cost is an inc, never a dict walk
_FRAMES_SENT = _obs.REGISTRY.counter("net.frames_sent")
_FRAMES_RECV = _obs.REGISTRY.counter("net.frames_recv")
_BYTES_SENT = _obs.REGISTRY.counter("net.bytes_sent")
_BYTES_RECV = _obs.REGISTRY.counter("net.bytes_recv")
_CONNECT_RETRIES = _obs.REGISTRY.counter("net.connect_retries")
_ENCODE_S = _obs.REGISTRY.histogram("net.encode_s")
_DECODE_S = _obs.REGISTRY.histogram("net.decode_s")
# frame-compression accounting (WH_NET_COMPRESS / per-call compress=):
# compressed payload bytes that actually crossed the wire, both
# directions, so the run report can state the codec's measured effect
_COMPRESS_OUT = _obs.REGISTRY.counter("net.compress.bytes_out")
_COMPRESS_IN = _obs.REGISTRY.counter("net.compress.bytes_in")
_BUSY_REJECTIONS = _obs.REGISTRY.counter("net.busy.rejections")
_BUSY_RETRIES = _obs.REGISTRY.counter("net.busy.retries")
# value-codec accounting: f32-equivalent bytes a quantized float payload
# WOULD have cost vs what it actually cost on the wire (savings =
# bytes_raw / bytes_wire); index arrays and raw floats are not counted
_WIRE_RAW = _obs.REGISTRY.counter("wire.codec.bytes_raw")
_WIRE_BYTES = _obs.REGISTRY.counter("wire.codec.bytes_wire")
_WIRE_EF_NORM = _obs.REGISTRY.gauge("wire.codec.ef_resid_norm")
# byte-shuffle framing: payload bytes that crossed the wire under
# comp="bshuf+zlib", both directions
_BSHUF_OUT = _obs.REGISTRY.counter("net.bshuf.bytes_out")
_BSHUF_IN = _obs.REGISTRY.counter("net.bshuf.bytes_in")


class InflightGate:
    """Server-side admission gate: at most WH_NET_MAX_INFLIGHT requests
    may be in their handler concurrently; the overflow gets a structured
    `busy` reply (see `busy_reply`) instead of queueing behind a
    saturated thread pool. 0 (the default) admits everything — existing
    PS deployments see no behavior change unless they opt in. The knob
    is read once at server construction; per-request cost at the default
    is a single None check."""

    def __init__(self, limit: Optional[int] = None):
        if limit is None:
            limit = int(os.environ.get("WH_NET_MAX_INFLIGHT", "0") or 0)
        self.limit = max(int(limit), 0)
        self._sem = (threading.BoundedSemaphore(self.limit)
                     if self.limit else None)

    def try_enter(self) -> bool:
        """Admit one request; False means the caller must send
        `busy_reply()` and NOT dispatch (and must not `leave()`)."""
        if self._sem is None:
            return True
        ok = self._sem.acquire(blocking=False)
        if not ok:
            _BUSY_REJECTIONS.inc()
        return ok

    def leave(self) -> None:
        if self._sem is not None:
            self._sem.release()


def busy_reply(retry_ms: float = 25.0) -> dict:
    """Header of the structured backpressure reply. Not an `error`:
    nothing was dispatched, the client should back off `retry_ms`
    (jittered) and resend the SAME frame — for seq-fenced ops the fence
    stamp is reused, so the eventual apply is still exactly-once.
    Servers pass `AdmissionController.busy_hint_ms()` here so the hint
    scales with observed reject pressure instead of pinning every
    bounced client to the same fixed 25 ms re-arrival."""
    return {"busy": 1, "retry_ms": float(retry_ms)}


def busy_backoff(header: dict, budget: Optional[_retry.RetryBudget] = None
                 ) -> bool:
    """Client side of the gate: True when `header` is a busy reply, after
    sleeping its hint under the unified full-jitter policy — the caller
    just retries its frame.  With a `budget` the sleep is additionally
    capped to the remaining retry window (and counted against it), so a
    storm of busy replies can't walk an op past its own deadline."""
    if not header.get("busy"):
        return False
    _BUSY_RETRIES.inc()
    hint = float(header.get("retry_ms", 25.0)) / 1000.0
    if budget is not None:
        budget.sleep(hint_s=hint)
    else:
        _retry.jitter_sleep(hint)
    return True


def connect_with_retry(addr: tuple[str, int], deadline_s: float = 30.0,
                       timeout: float = 60.0) -> socket.socket:
    """Dial `addr`, retrying refused/unreachable connections until
    `deadline_s` elapses.  The loop itself lives in runtime/retry.py
    (the unified deadline-budgeted policy); this wrapper keeps the
    historical `net.connect_retries` per-failure counter."""
    return _retry.connect(addr, deadline_s, timeout,
                          on_retry=_CONNECT_RETRIES.inc)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation of f32 to the high 16 bits."""
    u = a.view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _row_scales(a: np.ndarray, qmax: int) -> np.ndarray:
    """Per-row (axis-0) absmax scales for a 2-D+ array — one outlier row
    no longer flattens every other row's resolution (the historical
    global-absmax int8 bug)."""
    absmax = np.abs(a).reshape(a.shape[0], -1).max(axis=1)
    return np.maximum(absmax, 1e-30).astype(np.float32) / qmax


# scale-group width for 1-D arrays: one f32 absmax scale per GROUP of
# contiguous elements (4/64 = 6.25% overhead on int8). A scalar scale
# over a whole compacted touched-row vector is catastrophic for skewed
# tables — one hot FTRL z/n row flattens the resolution of the other
# ~10^5 rows in the same payload to zero and the model diverges (the
# same failure per-row scales fix for 2-D); groups keep the outlier's
# blast radius to 63 neighbors.
_GROUP = 64


def _group_scales(a: np.ndarray, qmax: int) -> np.ndarray:
    """Per-group absmax scales of a 1-D array (last group may be
    short)."""
    n = a.size
    ng = -(-n // _GROUP)
    absmax = np.abs(a)
    if ng * _GROUP != n:
        absmax = np.concatenate(
            [absmax, np.zeros(ng * _GROUP - n, np.float32)])
    gmax = absmax.reshape(ng, _GROUP).max(axis=1)
    return np.maximum(gmax, 1e-30).astype(np.float32) / qmax


def _expand_gscales(scale: np.ndarray, gs: int, goff: int,
                    n: int) -> np.ndarray:
    """Per-element scale vector of a (possibly sliced) grouped array:
    element i belongs to group (goff + i) // gs. Used identically by
    QuantRows.dequant and _decode so both ends multiply the same
    floats."""
    return np.repeat(scale, gs)[goff:goff + n]


def _pack4(q: np.ndarray) -> bytes:
    """Pack int8 values in [-7, 7] into nibbles, two per byte (bias +8
    so the packed range is 1..15; a trailing odd value pads with 0)."""
    b = (q.reshape(-1).astype(np.int16) + 8).astype(np.uint8)
    if b.size % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    return (b[0::2] | (b[1::2] << 4)).tobytes()


def _unpack4(buf: bytes, n: int) -> np.ndarray:
    """Inverse of _pack4: n int8 values in [-7, 7]."""
    b = np.frombuffer(buf, np.uint8)
    out = np.empty(2 * b.size, np.int8)
    out[0::2] = (b & 0x0F).astype(np.int8) - 8
    out[1::2] = (b >> 4).astype(np.int8) - 8
    return out[:n]


class QuantRows:
    """An array quantized ONCE, client-side, ahead of the frame layer.

    The EF push path quantizes a sync round's delta rows exactly once
    (at snapshot time) and hands the quantized form through push_sparse;
    row-range slicing for the per-server split and journal replay both
    operate on this object, so every (re)send of the same logical rows
    serializes to the same bytes — that determinism is what keeps the
    seq-fenced retry exactly-once under quantization.

    `q` holds the integer codes (int8 for int8/int4, uint16 for bf16);
    `scale` is a scalar (legacy peers), a per-row f32 vector aligned to
    axis 0 (2-D+), or — when `gs` is set — one f32 per `gs`-element
    GROUP of a 1-D array, with `goff` the phase of element 0 within the
    group grid (a contiguous slice keeps the parent's group boundaries,
    so per-server splits stay cheap views)."""

    __slots__ = ("enc", "q", "scale", "gs", "goff")

    def __init__(self, enc: str, q: np.ndarray, scale,
                 gs: Optional[int] = None, goff: int = 0):
        self.enc = enc
        self.q = q
        self.scale = scale
        self.gs = gs
        self.goff = goff

    @property
    def shape(self):
        return self.q.shape

    def __len__(self):
        return len(self.q)

    def __getitem__(self, sel) -> "QuantRows":
        if self.gs is not None:
            if not isinstance(sel, slice) or sel.step not in (None, 1):
                raise TypeError(
                    "grouped QuantRows supports contiguous slices only")
            a, b, _ = sel.indices(self.q.size)
            ga, gb = (self.goff + a) // self.gs, -(-(self.goff + b)
                                                   // self.gs)
            return QuantRows(self.enc, self.q[sel], self.scale[ga:gb],
                             self.gs, (self.goff + a) % self.gs)
        s = (self.scale[sel] if isinstance(self.scale, np.ndarray)
             else self.scale)
        return QuantRows(self.enc, self.q[sel], s)

    def dequant(self) -> np.ndarray:
        """The f32 values a receiver will decode — EXACTLY: the same
        integer-to-float multiply _decode performs, so the sender can
        account residuals against what the peer really applied."""
        if self.enc == "bf16":
            return (self.q.astype(np.uint32) << 16).view(np.float32)
        f = self.q.astype(np.float32)
        if self.gs is not None:
            return f * _expand_gscales(self.scale, self.gs, self.goff,
                                       f.size)
        if isinstance(self.scale, np.ndarray):
            return f * self.scale.reshape((-1,) + (1,) * (f.ndim - 1))
        return f * self.scale

    def wire_nbytes(self) -> int:
        """Pre-compression payload size _encode_quant will emit (the
        wire-savings accounting unit for wire_stats)."""
        n = int(self.q.size)
        if self.enc == "bf16":
            body = 2 * n
        elif self.enc == "int8":
            body = n
        else:  # int4: two codes per byte
            body = (n + 1) // 2
        if isinstance(self.scale, np.ndarray):
            body += 4 * int(self.scale.size)
        return body


def quantize_rows(a: np.ndarray, enc: str,
                  per_row: bool = True) -> QuantRows:
    """Quantize a float array under wire encoding `enc`. Per-row scales
    are used for 2-D+ arrays and per-_GROUP-element scales for 1-D
    arrays (unless `per_row` is False — the legacy / old-peer form,
    one scalar absmax scale)."""
    a = np.ascontiguousarray(a, np.float32)
    if enc == "bf16":
        return QuantRows("bf16", _bf16_round(a), None)
    qmax = 127 if enc == "int8" else 7
    if enc not in ("int8", "int4"):
        raise ValueError(f"unknown wire encoding {enc!r}")
    if per_row and a.ndim >= 2:
        scale = _row_scales(a, qmax)
        x = a / scale.reshape((-1,) + (1,) * (a.ndim - 1))
    elif per_row and a.ndim == 1 and a.size:
        scale = _group_scales(a, qmax)
        x = a / _expand_gscales(scale, _GROUP, 0, a.size)
        q = np.clip(np.round(x), -qmax, qmax).astype(np.int8)
        return QuantRows(enc, q, scale, _GROUP, 0)
    else:
        scale = float(max(np.max(np.abs(a), initial=0.0), 1e-30) / qmax)
        x = a / scale
    q = np.clip(np.round(x), -qmax, qmax).astype(np.int8)
    return QuantRows(enc, q, scale)


class EFQuant:
    """Sender-side error-feedback accumulator over a sparse row space:
    transmit Q(x + r), keep r <- (x + r) - Q(.) so the quantization
    error of every row is re-injected the next time that row ships,
    making int8/int4 value streams unbiased over time.

    Residual support is the set of rows ever sent and not yet fully
    corrected, stored as a sorted index vector + aligned value rows
    (vectorized searchsorted merge — no per-row Python). `cap` bounds
    the support; overflow drops the smallest-magnitude residuals (the
    ones that matter least) and counts them.

    Used on both halves of the PS plane: SyncedStore's push path (one
    accumulator per table, advanced ONCE per logical sync — journal
    replays and need_keys resends reuse the returned QuantRows, so a
    seq-fenced retry can never double-apply a residual) and the PS
    server's pull side (one accumulator per sender per table; pulls are
    absolute-value refreshes, so a lost reply self-corrects on the next
    pull instead of double-counting)."""

    def __init__(self, enc: str, per_row: bool = True,
                 cap: int = 1 << 22):
        self.enc = enc
        self.per_row = per_row
        self.cap = int(cap)
        self.dropped = 0
        self._idx = np.empty(0, np.int64)
        self._val: Optional[np.ndarray] = None

    def apply(self, idx: np.ndarray, values: np.ndarray) -> QuantRows:
        """Quantize `values` (rows aligned to sorted-unique global ids
        `idx`) with this state's residuals folded in; advances the
        residuals. Call ONCE per logical send — replays must reuse the
        returned QuantRows, never re-apply."""
        idx = np.asarray(idx, np.int64)
        x = np.array(values, np.float32, copy=True)
        if self._idx.size and idx.size:
            pos = np.minimum(np.searchsorted(self._idx, idx),
                             self._idx.size - 1)
            hit = self._idx[pos] == idx
            if hit.any():
                x[hit] += self._val[pos[hit]]
        qr = quantize_rows(x, self.enc, self.per_row)
        r = x - qr.dequant()
        if self._idx.size:
            if idx.size:
                pos = np.minimum(np.searchsorted(idx, self._idx),
                                 idx.size - 1)
                keep = idx[pos] != self._idx
            else:
                keep = np.ones(self._idx.size, bool)
            new_idx = np.concatenate([self._idx[keep], idx])
            new_val = np.concatenate([self._val[keep], r])
            order = np.argsort(new_idx, kind="stable")
            self._idx, self._val = new_idx[order], new_val[order]
        else:
            self._idx = idx.copy()
            self._val = r
        if self._idx.size > self.cap:
            norm = np.abs(self._val).reshape(self._idx.size, -1).max(axis=1)
            keep_i = np.sort(np.argpartition(norm, -self.cap)[-self.cap:])
            self.dropped += self._idx.size - self.cap
            self._idx, self._val = self._idx[keep_i], self._val[keep_i]
        _WIRE_EF_NORM.set(self.resid_norm())
        if os.environ.get("WH_WIRE_DEBUG"):
            dq = qr.dequant()
            print(f"[efq] n={idx.size} |d|max={np.abs(values).max():.3g}"
                  f" |x|max={np.abs(x).max():.3g}"
                  f" |r|max={np.abs(r).max():.3g}"
                  f" |err|={np.linalg.norm(x - dq):.3g}"
                  f" resid_norm={self.resid_norm():.3g}",
                  file=sys.stderr, flush=True)
        return qr

    def resid_norm(self) -> float:
        if self._val is None or not self._idx.size:
            return 0.0
        return float(np.linalg.norm(self._val))

    def reset(self) -> None:
        """Drop all residual state (restore / reconnect invalidation:
        the peer's adopted values rolled back, so the accumulated error
        no longer describes anything)."""
        self._idx = np.empty(0, np.int64)
        self._val = None


def _bshuf(buf: bytes, itemsize: int) -> bytes:
    """Byte-plane shuffle: transpose the N x itemsize byte view so the
    k-th byte of every element lands contiguously. Float exponent bytes
    are near-constant across a table, so the shuffled stream compresses
    both better and FASTER under zlib-1 (long literal runs)."""
    b = np.frombuffer(buf, np.uint8)
    return b.reshape(-1, itemsize).T.tobytes()


def _unbshuf(buf: bytes, itemsize: int) -> bytes:
    b = np.frombuffer(buf, np.uint8)
    return b.reshape(itemsize, -1).T.tobytes()


_ENC_ITEMSIZE = {"raw": 4, "bf16": 2, "i32": 4, "i64": 8}


def _compress_buf(meta: dict, buf: bytes, mode: str) -> bytes:
    """Apply the negotiated frame compression to one encoded buffer.
    `mode` is "zlib" or "bshuf" (bshuf composes the byte-plane shuffle
    with zlib-1 and falls back to plain zlib for single-byte or
    mixed-layout encodings, where there is nothing to transpose)."""
    if len(buf) < _COMPRESS_MIN:
        return buf
    isz = _ENC_ITEMSIZE.get(meta["enc"], 1)
    if mode == "bshuf" and isz > 1 and len(buf) % isz == 0:
        # level 6 here, not 1: the shuffle concentrates the stream's
        # redundancy into long same-plane runs (near-constant exponent
        # bytes, zeroed high planes of delta-coded indices) where the
        # deeper match search keeps paying; the noisy mantissa planes
        # fall out as stored blocks either way. Plain zlib below stays
        # at 1 — it only ever sees unshuffled int8/mixed buffers where
        # level 6 buys ~nothing and costs the whole deflate budget.
        c = zlib.compress(_bshuf(buf, isz), 6)
        tag = "bshuf+zlib"
    else:
        c = zlib.compress(buf, 1)
        tag = "zlib"
    if len(c) < len(buf):
        meta.update(comp=tag, rawbytes=meta["nbytes"], nbytes=len(c))
        return c
    return buf


def _encode(a, fixed_bytes: int = 0,
            compress=False) -> tuple[dict, bytes]:
    """Encode one array for the wire. Float arrays honor fixed_bytes:
    0 = raw f32, 2 = bfloat16 bit-truncation (round-to-nearest-even),
    1 = absmax int8. Integer arrays always go raw (they are row indices;
    rounding them would corrupt the scatter). A QuantRows input is
    already quantized (the EF paths) and serializes deterministically.
    `compress` may be False, True/"zlib", or "bshuf"."""
    if isinstance(a, QuantRows):
        meta, buf = _encode_quant(a)
    else:
        meta = {"shape": list(a.shape)}
        if np.issubdtype(a.dtype, np.integer):
            a = np.ascontiguousarray(
                a, dtype=np.int64 if a.dtype.itemsize > 4 else np.int32)
            enc = "i64" if a.dtype == np.int64 else "i32"
            if compress == "bshuf" and a.ndim == 1 and a.size >= 128:
                # delta-encode sorted key lists (the classic PS wire
                # trick): sorted-unique row indices become first value +
                # gaps, whose high byte planes are ~all zero — bshuf+zlib
                # then collapses them, where the absolute values' low
                # bytes are incompressible noise. Lossless (cumsum on
                # decode), gated on the negotiated bshuf mode so old
                # peers never see the form.
                d = np.diff(a)
                if d.size == 0 or bool((d >= 0).all()):
                    out = np.empty_like(a)
                    if a.size:
                        out[0] = a[0]
                        out[1:] = d
                    a = out
                    meta["dlt"] = 1
            buf = a.tobytes()
            meta.update(enc=enc, nbytes=len(buf))
        else:
            a = np.ascontiguousarray(a, dtype=np.float32)
            if fixed_bytes == 0:
                buf = a.tobytes()
                meta.update(enc="raw", nbytes=len(buf))
            elif fixed_bytes >= 2:
                buf = _bf16_round(a).tobytes()
                meta.update(enc="bf16", nbytes=len(buf))
            else:
                scale = float(
                    max(np.max(np.abs(a), initial=0.0), 1e-30) / 127.0)
                q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
                buf = q.tobytes()
                meta.update(enc="int8", scale=scale, nbytes=len(buf))
    if meta["enc"] not in ("raw", "i32", "i64"):
        _WIRE_RAW.inc(4 * int(np.prod(meta["shape"], dtype=np.int64)))
        _WIRE_BYTES.inc(meta["nbytes"])
    if compress:
        mode = compress if isinstance(compress, str) else "zlib"
        buf = _compress_buf(meta, buf, mode)
        if meta.get("comp") == "bshuf+zlib":
            _BSHUF_OUT.inc(meta["nbytes"])
    return meta, buf


def _encode_quant(a: QuantRows) -> tuple[dict, bytes]:
    """Serialize a pre-quantized array. Wire forms:
    bf16   — identical to the fixed_bytes=2 encoding;
    int8   — scalar scale (the legacy form old peers decode);
    int8r  — per-row scales: q bytes then shape[0] f32 scales;
    int8g  — grouped 1-D: q bytes then per-group f32 scales, group
             size and slice phase in meta (gs/goff);
    int4   — nibble-packed, scalar scale;
    int4r / int4g — nibble-packed per-row / grouped forms."""
    meta: dict = {"shape": list(a.shape)}
    per_row = isinstance(a.scale, np.ndarray)
    grouped = a.gs is not None
    if a.enc == "bf16":
        buf = np.ascontiguousarray(a.q).tobytes()
        meta.update(enc="bf16", nbytes=len(buf))
    elif a.enc == "int8":
        buf = np.ascontiguousarray(a.q).tobytes()
        if grouped:
            buf += np.ascontiguousarray(a.scale, np.float32).tobytes()
            meta.update(enc="int8g", gs=a.gs, goff=a.goff,
                        nbytes=len(buf))
        elif per_row:
            buf += np.ascontiguousarray(a.scale, np.float32).tobytes()
            meta.update(enc="int8r", nbytes=len(buf))
        else:
            meta.update(enc="int8", scale=float(a.scale), nbytes=len(buf))
    elif a.enc == "int4":
        buf = _pack4(a.q)
        if grouped:
            buf += np.ascontiguousarray(a.scale, np.float32).tobytes()
            meta.update(enc="int4g", gs=a.gs, goff=a.goff,
                        nbytes=len(buf))
        elif per_row:
            buf += np.ascontiguousarray(a.scale, np.float32).tobytes()
            meta.update(enc="int4r", nbytes=len(buf))
        else:
            meta.update(enc="int4", scale=float(a.scale), nbytes=len(buf))
    else:
        raise ValueError(f"unknown quantized encoding {a.enc!r}")
    return meta, buf


def key_digest(idx: np.ndarray) -> str:
    """Content fingerprint of a key (row-index) vector, the unit of the
    KEY_CACHING filter: two frames whose sorted-unique index arrays hash
    equal carry the same key list, so the second can ship digest-only.
    blake2b like the pack cache's fingerprints — fast and collision-safe
    at 12 bytes for the per-sender cache sizes involved."""
    a = np.ascontiguousarray(idx, np.int64)
    return hashlib.blake2b(a.tobytes(), digest_size=12).hexdigest()


def _decode(meta: dict, buf: bytes) -> np.ndarray:
    shape = tuple(meta["shape"])
    enc = meta["enc"]
    comp = meta.get("comp")
    if comp == "zlib":
        buf = zlib.decompress(buf)
    elif comp == "bshuf+zlib":
        buf = _unbshuf(zlib.decompress(buf), _ENC_ITEMSIZE[enc])
    if enc == "raw":
        return np.frombuffer(buf, np.float32).reshape(shape)
    if enc == "i32":
        a = np.frombuffer(buf, np.int32).reshape(shape)
        return np.cumsum(a, dtype=np.int32) if meta.get("dlt") else a
    if enc == "i64":
        a = np.frombuffer(buf, np.int64).reshape(shape)
        return np.cumsum(a, dtype=np.int64) if meta.get("dlt") else a
    if enc == "bf16":
        u = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return u.view(np.float32).reshape(shape)
    if enc == "int8":
        q = np.frombuffer(buf, np.int8).astype(np.float32)
        return (q * meta["scale"]).reshape(shape)
    n = int(np.prod(shape, dtype=np.int64))
    nrows = shape[0] if shape else 1
    if enc == "int8r":
        q = np.frombuffer(buf, np.int8, count=n).astype(np.float32)
        s = np.frombuffer(buf, np.float32, offset=n)
        return q.reshape(shape) * s.reshape((nrows,) + (1,) * (len(shape) - 1))
    if enc == "int8g":
        q = np.frombuffer(buf, np.int8, count=n).astype(np.float32)
        s = np.frombuffer(buf, np.float32, offset=n)
        return (q * _expand_gscales(s, meta["gs"], meta.get("goff", 0),
                                    n)).reshape(shape)
    if enc == "int4":
        q = _unpack4(buf, n).astype(np.float32)
        return (q * meta["scale"]).reshape(shape)
    if enc == "int4r":
        npk = (n + 1) // 2
        q = _unpack4(buf[:npk], n).astype(np.float32)
        s = np.frombuffer(buf, np.float32, offset=npk)
        return q.reshape(shape) * s.reshape((nrows,) + (1,) * (len(shape) - 1))
    if enc == "int4g":
        npk = (n + 1) // 2
        q = _unpack4(buf[:npk], n).astype(np.float32)
        s = np.frombuffer(buf, np.float32, offset=npk)
        return (q * _expand_gscales(s, meta["gs"], meta.get("goff", 0),
                                    n)).reshape(shape)
    raise ValueError(f"unknown encoding {enc!r}")


def _read_exact(sock_file, n: int) -> Optional[bytes]:
    chunks = []
    while n > 0:
        c = sock_file.read(n)
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def send_frame(sock_file, header: dict,
               arrays: Optional[dict[str, np.ndarray]] = None,
               fixed_bytes: int = 0, compress=False) -> int:
    """Write one frame; returns the number of payload+header bytes sent
    (the wire-accounting unit PSClient reports). `compress` is False,
    True/"zlib", or "bshuf" (the negotiated frame compression mode);
    array values may be plain ndarrays or pre-quantized QuantRows."""
    if faults.ACTIVE is not None:
        faults.ACTIVE.frame(header.get("op"))
    t0 = time.perf_counter()
    metas, bufs = [], []
    for name, a in (arrays or {}).items():
        m, b = _encode(a, fixed_bytes, compress)
        m["name"] = name
        metas.append(m)
        bufs.append(b)
    header = dict(header, arrays=metas)
    if _trace.ACTIVE is not None:
        # a sampled request's trace context rides the header (the
        # key_digest piggyback pattern) so the receiver's spans stitch
        # to the sender's in tools/trace_viewer.py
        tc = _trace.wire_ctx()
        if tc is not None:
            header["tctx"] = tc
    # the ambient deadline rides the same way: remaining seconds at
    # send time (`dl`), re-anchored to the receiver's monotonic clock
    # in recv_frame — clock skew between hosts never touches it
    dl = _overload.wire_deadline()
    if dl is not None:
        header["dl"] = dl
    h = json.dumps(header).encode()
    _ENCODE_S.observe(time.perf_counter() - t0)
    if os.environ.get("WH_WIRE_DEBUG") == "2" and metas:
        print("[wire]", header.get("op"),
              [(m["name"], m["enc"], m.get("comp", "-"), m["nbytes"])
               for m in metas], file=sys.stderr, flush=True)
    comp = sum(m["nbytes"] for m in metas if "comp" in m)
    if comp:
        _COMPRESS_OUT.inc(comp)
    sock_file.write(struct.pack(">I", len(h)))
    sock_file.write(h)
    total = 4 + len(h)
    for b in bufs:
        sock_file.write(b)
        total += len(b)
    sock_file.flush()
    _FRAMES_SENT.inc()
    _BYTES_SENT.inc(total)
    return total


def recv_frame(sock_file) -> Optional[tuple[dict, dict[str, np.ndarray], int]]:
    if faults.ACTIVE is not None:
        faults.ACTIVE.recv()
    raw = _read_exact(sock_file, 4)
    if raw is None:
        return None
    (hlen,) = struct.unpack(">I", raw)
    h = _read_exact(sock_file, hlen)
    if h is None:
        return None
    # decode latency excludes the socket reads (network wait is not
    # deserialization cost): time json.loads + _decode only
    t0 = time.perf_counter()
    header = json.loads(h)
    decode_s = time.perf_counter() - t0
    _overload.arm(header)  # anchor a carried deadline: dl -> dl_mono
    if _flight.ACTIVE is not None and header.get("dl") is not None:
        # per-hop deadline audit: budget this frame arrived with
        _flight.record_hop(header.get("op"), float(header["dl"]))
    total = 4 + hlen
    arrays = {}
    for m in header.get("arrays", []):
        buf = _read_exact(sock_file, m["nbytes"])
        if buf is None:
            return None
        total += m["nbytes"]
        t0 = time.perf_counter()
        arrays[m["name"]] = _decode(m, buf)
        decode_s += time.perf_counter() - t0
        if "comp" in m:
            _COMPRESS_IN.inc(m["nbytes"])
            if m["comp"] == "bshuf+zlib":
                _BSHUF_IN.inc(m["nbytes"])
    _DECODE_S.observe(decode_s)
    _FRAMES_RECV.inc()
    _BYTES_RECV.inc(total)
    return header, arrays, total
