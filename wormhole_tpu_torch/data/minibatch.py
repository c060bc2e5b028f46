"""MinibatchIter: stream fixed-size RowBlock minibatches from file parts.

Parity with reference learn/base/minibatch_iter.h:
- wraps the parser in a background prefetch thread (ThreadedParser, :60)
- fixed minibatch size with carry-over across parsed chunks (:75-131)
- shuffle buffer: accumulate `shuf_buf` rows, random-permute, emit (:83-91)
- negative downsampling with label-dependent keep probability (:103-107)
- format dispatch libsvm/criteo/criteo_test/adfea/crb (:42-59)

Given the same seed, it draws the same random numbers in the same order
as the JAX package's MinibatchIter, so both emit the same batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from wormhole_tpu_torch.data import parsers
from wormhole_tpu_torch.data.rowblock import RowBlock


def _iter_rowblocks(filename: str, part: int, num_parts: int,
                    fmt: str, device=None) -> Iterator[RowBlock]:
    """A part's RowBlocks: crb records read on the host (data/crb.py), or
    text chunks parsed on `device` (parsers.parse_text)."""
    if fmt == "crb":
        from wormhole_tpu_torch.data import crb

        yield from crb.read_crb(filename, part, num_parts)
        return
    for chunk in parsers.iter_file_chunks(filename, part, num_parts):
        blk = parsers.parse_text(chunk, fmt, device)
        if blk.size:
            yield blk


#: end-of-stream marker on the ThreadedParser queue
_END = object()


class _ParserError:
    """Queue sentinel carrying a producer-thread exception to the
    consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class ThreadedParser:
    """Background prefetch over a RowBlock source (the reference's
    ThreadedParser, minibatch_iter.h:60).

    The producer's terminal state, end of stream or an exception, always
    travels on the queue itself (the `_END` / `_ParserError` sentinels),
    so a consumer blocked in `get()` always gets a next item, and a parse
    error raises where the consumer iterates.

    On CUDA the producer parses on a stream of its own: a thread does not
    inherit its creator's `torch.cuda.stream(...)` context, and the
    default stream is the steps'. The parse syncs that stream before it
    hands its arrays back (native.parse_libsvm_cuda and the other
    formats' parse_*_cuda), so the consumer
    reads finished host arrays."""

    #: parsed blocks the producer may hold ahead of the consumer
    MAX_AHEAD = 4

    def __init__(self, src, device=None):
        self._src = src
        self._device = device
        self._q: queue.Queue = queue.Queue(maxsize=self.MAX_AHEAD)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up once the consumer went away, so an
        iterator abandoned mid-stream cannot park the producer (and its
        open file) forever."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        dev = self._device
        on_card = dev is not None and torch.device(dev).type == "cuda"
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev) if on_card
                                   else None):
                for blk in self._src:
                    if not self._put(blk):
                        return
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._put(_ParserError(e))

    def close(self) -> None:
        self._stop.set()

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is _END:
                    return
                if isinstance(item, _ParserError):
                    raise item.exc
                yield item
        finally:
            self.close()


class MinibatchIter:
    """Iterate fixed-size minibatches over (part k of n) of one file,
    parsed on `device` (parsers.parse_text: None is the CPU's parser), by
    a ThreadedParser unless `prefetch` is off."""

    def __init__(
        self,
        filename: str,
        part: int = 0,
        num_parts: int = 1,
        fmt: str = "libsvm",
        minibatch_size: int = 1024,
        shuf_buf: int = 0,
        neg_sampling: float = 1.0,
        prefetch: bool = True,
        seed: int = 0,
        device=None,
    ):
        self.filename = filename
        self.part = part
        self.num_parts = num_parts
        self.fmt = fmt
        self.minibatch_size = int(minibatch_size)
        self.shuf_buf = int(shuf_buf)
        self.neg_sampling = float(neg_sampling)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.device = device

    def _raw_blocks(self) -> Iterator[RowBlock]:
        src = _iter_rowblocks(self.filename, self.part, self.num_parts,
                              self.fmt, self.device)
        if not self.prefetch:
            yield from src
            return
        yield from ThreadedParser(src, device=self.device)

    def _transformed(self) -> Iterator[RowBlock]:
        for blk in self._raw_blocks():
            if self.neg_sampling < 1.0:
                blk = self._neg_sample(blk)
                if blk.size == 0:
                    continue
            yield blk

    def _neg_sample(self, blk: RowBlock) -> RowBlock:
        keep = (blk.label > 0) | (
            self.rng.random(blk.size) < self.neg_sampling
        )
        if keep.all():
            return blk
        return _take_rows(blk, np.nonzero(keep)[0])

    def __iter__(self) -> Iterator[RowBlock]:
        mb = self.minibatch_size
        if self.shuf_buf > 0:
            buf: list[RowBlock] = []
            buffered = 0
            for blk in self._transformed():
                buf.append(blk)
                buffered += blk.size
                if buffered >= max(self.shuf_buf, mb):
                    yield from self._drain(buf, flush=False)
                    buffered = sum(b.size for b in buf)
            if buf:
                yield from self._drain(buf, flush=True)
        else:
            # emit cursor-advanced slices of each parsed chunk; only the
            # sub-minibatch tail is carried into the next chunk
            tail: Optional[RowBlock] = None
            for blk in self._transformed():
                if tail is not None and tail.size:
                    blk = RowBlock.concat([tail, blk])
                    tail = None
                pos = 0
                while blk.size - pos >= mb:
                    yield blk.slice(pos, pos + mb)
                    pos += mb
                tail = blk.slice(pos, blk.size) if pos < blk.size else None
            if tail is not None and tail.size:
                yield tail

    def _drain(self, buf: list[RowBlock], flush: bool) -> Iterator[RowBlock]:
        big = RowBlock.concat(buf)
        perm = self.rng.permutation(big.size)
        big = _take_rows(big, perm)
        mb = self.minibatch_size
        n_emit = big.size if flush else (big.size // mb) * mb
        for b in range(0, n_emit, mb):
            yield big.slice(b, min(b + mb, n_emit))
        buf.clear()
        if n_emit < big.size:
            buf.append(big.slice(n_emit, big.size))


def _take_rows(blk: RowBlock, rows: np.ndarray) -> RowBlock:
    """Gather a subset/permutation of rows into a new RowBlock."""
    lens = np.diff(blk.offset)[rows]
    offset = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=offset[1:])
    starts = blk.offset[rows]
    gather = np.concatenate(
        [np.arange(s, s + l, dtype=np.int64) for s, l in zip(starts, lens)]
    ) if len(rows) else np.zeros(0, dtype=np.int64)
    return RowBlock(
        label=blk.label[rows],
        offset=offset,
        index=blk.index[gather],
        value=None if blk.value is None else blk.value[gather],
        weight=None if blk.weight is None else blk.weight[rows],
    )
