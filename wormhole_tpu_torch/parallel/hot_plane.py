"""Hot parameter plane: device-resident tables, cold TCP tier.

The port's copy of the JAX package's parallel/hot_plane.py, with the
same contract. The TCP plane (`runtime/ps_server.SyncedStore`)
round-trips every `max_delay` minibatches through host memory and
sockets — the right shape when workers are separate processes, and pure
overhead when every data-parallel worker of the job lives in ONE process
on its local devices. There the model and optimizer tables already live
once on the card (`parallel/kvstore.KVStore`, or the store of the
worker's local mesh), and the learner's step already gathers its rows
(ZPull) and updates them in place (ZPush): there is nothing left for a
per-step host round-trip to do.

`HotPlane` therefore keeps the `SyncedStore` surface the solver and
runner already speak (`maybe_sync` / `sync` / `flush` / `pull` /
`wire_stats`) but inverts the authority relation:

- **Hot tier = the device store.** `maybe_sync()` only counts steps. No
  RPC, no host copy, no wire bytes on the training path.
- **Cold tier = the TCP server group**, demoted to spill, epoch-stamped
  snapshots and the saved model. It is reconciled only at `flush()`
  barriers (part ends, pass boundaries, checkpoints, predict — the
  points `minibatch_solver` and `apps/_runner.py` already fence): one
  sparse delta push of every row touched since the last barrier, then a
  versioned pull that refreshes the base mirror.
- **Pulls never write the device.** The base mirror tracks the server
  exactly (base == server after every reconcile), so a barrier delta
  (cur - base) drives the cold tier toward the device state: the cold
  tier is a MIRROR of the authoritative device tables, not a merge
  point (the hot plane requires all data-parallel workers in this
  process, so there are no concurrent pushers to merge). After a server
  restore the rolled-back shard is re-zeroed in the mirror and the next
  flush falls back to the full-table delta scan, re-uploading the
  authoritative device rows wholesale.

Adoption at `init()` (and a dense `pull()` before it) is the one
exception to pull-never-writes: before any training step the SERVER is
authoritative (checkpoint-loaded state, `model_in` warm starts), so the
startup pull scatters into the device store like the TCP plane. From
the first step on, the device is.

The port's versioned pull differs from the JAX one in two ways that the
override keeps: it asks the servers to skip derived tables on a
quantized wire (`_pull_skip`) and rebuilds them from their sources
(`_fill_derived`), so DiFacto's and FTRL's derived w in the mirror stays
the servers' own.

Selection is one knob: `WH_PS_PLANE={auto,tcp,hot}` (config.py
registry); `auto` picks `hot` when the job has one worker process and
`torch.cuda.device_count() >= 2` (`apps/_runner.py`).
"""

from __future__ import annotations

import numpy as np

from wormhole_tpu_torch.obs import metrics as _obs
from wormhole_tpu_torch.runtime.ps_server import SyncedStore, shard_range

_HOT_STEPS = _obs.REGISTRY.counter("ps.hot.steps")
_HOT_FLUSHES = _obs.REGISTRY.counter("ps.hot.flushes")


class HotPlane(SyncedStore):
    """SyncedStore with the device store authoritative and the TCP
    server group demoted to a flush-barrier cold tier."""

    def __init__(self, store, client, **kw):
        # the async comms thread exists to hide per-step round-trips the
        # hot plane doesn't make; flush barriers want the synchronous
        # path's "state is settled when this returns" guarantee — so the
        # env default (WH_ASYNC_SYNC, exported by drivers for the TCP
        # plane) must not leak in
        kw["async_sync"] = False
        super().__init__(store, client, **kw)
        self._adopting = False
        self._hot_steps = 0
        # armed by a rollback re-pull: the next flush pushes the FULL
        # cur - base scan instead of the touched-row hints, so server
        # rows that rolled back but weren't touched recently still get
        # repaired from the device at the very next barrier
        self._force_scan = False

    # -- hot tier: the training path ------------------------------------
    def maybe_sync(self) -> bool:
        """Per-minibatch hook: count the step, nothing else — the step
        already updated the device tables in place."""
        self._steps += 1
        self._hot_steps += 1
        _HOT_STEPS.inc()
        return False

    # -- cold tier: flush-barrier reconciliation ------------------------
    def init(self) -> None:
        # startup is the one server-authoritative moment: adopt
        # checkpoint-loaded / warm-start rows into the device store
        self._adopting = True
        try:
            super().init()
        finally:
            self._adopting = False

    def pull(self) -> None:
        if self._clocks is None:
            # dense re-adoption (cold -> hot handoff); server is
            # authoritative here by construction
            self._adopting = True
            try:
                super().pull()
            finally:
                self._adopting = False
            return
        super().pull()

    def _apply_pull(self) -> None:
        """Versioned pull into the BASE MIRROR ONLY (the device store is
        authoritative once training started). Keeps the invariant
        base == server: a rolled-back (snapshot-restored) shard is
        re-zeroed in the mirror before adopting its since=0 re-pull —
        rows first stamped after the snapshot are back at zero init on
        the server and absent from the pull — so the next flush's
        cur - base delta re-uploads the device's authoritative rows
        wholesale. (Non-zero-init tables can't be re-zeroed; for them a
        rolled-back row keeps the TCP plane's bounded-loss behavior:
        the next delta restores progress since the last barrier only.)"""
        if self._adopting:
            super()._apply_pull()
            return
        c = self.client
        # pull_sparse consumes the rollback flags (they force since=0);
        # capture them first so we know which shards to re-zero
        rolled = [r for r in range(c.world) if c._rolled_back[r]]
        clocks, groups, tables = c.pull_sparse(
            self._clocks, compress=self.compress, skip=self._pull_skip())
        tables = self._fill_derived(groups, tables)
        if rolled:
            zero = (self.store.zero_init_names()
                    if hasattr(self.store, "zero_init_names")
                    else set())
            for k in self._base:
                if k not in zero:
                    continue
                n = c.full_rows[k]
                for r in rolled:
                    lo, hi = shard_range(n, r, c.world)
                    self._base[k][lo:hi] = 0.0
            self._force_scan = True
        for k, rows in tables.items():
            idx = groups[c.full_rows[k]]
            if idx.size == 0:
                continue
            self._base[k][idx] = np.asarray(rows, np.float32)
        self._clocks = clocks

    def _touched_groups(self):
        if self._force_scan:
            # rollback repair: push the full-table delta once so server
            # rows outside the recent touched set re-adopt the device
            self._force_scan = False
            if self.touched_fn is not None:
                self.touched_fn()  # drain the accumulator; the scan
            return None            # covers everything it named
        return super()._touched_groups()

    def _sync_now(self) -> None:
        super()._sync_now()
        _HOT_FLUSHES.inc()

    def wire_stats(self) -> dict:
        d = super().wire_stats()
        d["plane"] = "hot"
        mesh = getattr(self.store, "mesh", None)
        d["devices"] = int(mesh.size) if mesh is not None else 1
        d["hot_steps"] = self._hot_steps
        d["flushes"] = self.num_syncs
        return d
