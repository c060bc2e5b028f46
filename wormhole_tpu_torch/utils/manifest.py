"""Snapshot-set manifest: atomic discovery of a consistent shard set.

The port's copy of the JAX package's utils/manifest.py, renamed to this
package and sharing nothing with it: a snapshot set either package
writes loads in the other.

The JAX package's `ps_server.start_snapshots` writes each shard's
`<base>_part-<rank>.npz` independently, on its own cadence. Before this
module, any reader that wanted the full set (serving watcher,
`restore_snapshot` on a rescaled world) had to glob — and a glob can
pair a rank's half-replaced file with another rank's older one (the
torn-read window). The fix is a single `<base>_MANIFEST.json` next to
the parts: every snapshot cycle a shard updates its own entry (file
name, blake2b digest, clock, epoch) under an flock'd read-modify-write
and bumps a monotone `version` counter, writing the result with the
usual temp+rename. Readers take the manifest as ground truth: load
exactly the files it names, verify each against its digest, and retry
from a fresh manifest on mismatch (`TornSnapshot`) — a part replaced
mid-read can only ever be detected, never silently mixed in.

`version` doubles as the serving tier's model epoch: it bumps on every
manifest commit (per part for ps_server's independent shard cadences;
once per FULL set for `write_snapshot_set`, whose
`commit_manifest_set` publishes all parts in one cycle so no
intermediate manifest can pair a new part with a stale one), so "the
manifest version grew" is exactly "newer model state is on disk"
(wormhole_tpu_torch/serving/server.py polls it).

The digest is blake2b-12 like `net.key_digest` and the pack cache's
fingerprints — fast, and collision-safe at these set sizes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Optional

import numpy as np

from wormhole_tpu_torch.utils.checkpoint import atomic_savez, part_name

_DIGEST_SIZE = 12


class TornSnapshot(Exception):
    """A part file did not match its manifest digest: the set was
    updated between the manifest read and the part read. Re-read the
    manifest and retry — the new one names the replacement file."""


def manifest_path(base: str) -> str:
    return base + "_MANIFEST.json"


def blob_digest(blob: bytes) -> str:
    return hashlib.blake2b(blob, digest_size=_DIGEST_SIZE).hexdigest()


def file_digest(path: str) -> str:
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


def read_manifest(base: str) -> Optional[dict]:
    """Parse the manifest, or None when absent/corrupt (a crash between
    the lockfile and the rename can't corrupt it — the write is atomic —
    but a reader must survive a hand-edited or truncated file)."""
    try:
        with open(manifest_path(base), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def complete(man: Optional[dict]) -> bool:
    """True when every rank of the writing world has an entry."""
    return bool(man) and len(man.get("parts", {})) >= int(man.get("world", 0))


def _locked_commit(base: str, world: int, fold) -> int:
    """One flock'd read-modify-write manifest cycle: `fold(parts)`
    mutates the part map in place, then the whole manifest is replaced
    atomically with `version` bumped ONCE. A world change resets the
    part set — mixed-world entries must never coexist, or a reader
    would concatenate incompatible shards."""
    import fcntl

    mpath = manifest_path(base)
    with open(mpath + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        man = read_manifest(base) or {}
        if int(man.get("world", world)) != world:
            man = {}
        version = int(man.get("version", 0)) + 1
        parts = man.get("parts", {})
        full_rows = fold(parts)
        man = {"version": version, "world": int(world), "parts": parts,
               "full_rows": {k: int(v) for k, v in (full_rows or {}).items()}}
        tmp = f"{mpath}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, mpath)
    return version


def update_manifest(base: str, rank: int, world: int, path: str,
                    clock: int, epoch: int, full_rows: dict,
                    digest: Optional[str] = None) -> int:
    """Fold one shard's freshly written part into the manifest and bump
    `version`; returns the new version. Concurrent shard processes
    serialize on an flock'd sidecar (the manifest itself is replaced
    atomically, so the lock only orders read-modify-write cycles)."""
    if digest is None:
        digest = file_digest(path)

    def fold(parts: dict) -> dict:
        parts[str(rank)] = {
            "file": os.path.basename(path),
            "digest": digest,
            "clock": int(clock),
            "epoch": int(epoch),
        }
        return full_rows

    return _locked_commit(base, world, fold)


def commit_manifest_set(base: str, world: int, entries: dict,
                        full_rows: dict) -> int:
    """Publish a FULL part set in ONE manifest cycle — `entries` maps
    every rank to its part entry dict (file/digest/clock/epoch). Unlike
    world per-part `update_manifest` calls, no intermediate manifest
    ever pairs a new part with a stale one, so a watcher can never
    adopt (and stamp a version on) a cross-part-torn set. This is the
    commit `write_snapshot_set` uses; ps_server keeps per-part updates
    because its shards genuinely snapshot on independent cadences."""
    if sorted(entries) != list(range(world)):
        raise ValueError(f"entries must cover ranks 0..{world - 1}, "
                         f"got {sorted(entries)}")

    def fold(parts: dict) -> dict:
        parts.clear()
        for r, e in entries.items():
            parts[str(r)] = dict(e)
        return full_rows

    return _locked_commit(base, world, fold)


def read_part(base: str, man: dict, rank: int) -> dict[str, np.ndarray]:
    """One part's arrays, digest-verified against the manifest. The file
    is slurped once and both hashed and parsed from that buffer, so the
    verified bytes ARE the loaded bytes even if the file is replaced
    between the two."""
    entry = man["parts"].get(str(rank))
    if entry is None:
        raise TornSnapshot(f"manifest names no part for rank {rank}")
    path = os.path.join(os.path.dirname(base) or ".", entry["file"])
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise TornSnapshot(f"part {path} unreadable: {e}") from e
    if blob_digest(blob) != entry["digest"]:
        raise TornSnapshot(f"part {path} does not match its manifest "
                           "digest (replaced mid-read?)")
    return dict(np.load(io.BytesIO(blob)))


def shard_range(n: int, rank: int, world: int) -> tuple[int, int]:
    """The same even split ps_server/checkpoint use (duplicated here so
    utils never imports the runtime package)."""
    return n * rank // world, n * (rank + 1) // world


def load_slices(base: str, want: dict[str, tuple[int, int]],
                manifest: Optional[dict] = None) -> tuple[dict, dict]:
    """Load row ranges `{table: (lo, hi)}` of the full (concatenated)
    tables from a manifest-described snapshot set, reading only the
    parts that overlap each range. Returns `(tables, meta)` where meta
    carries the manifest version and the max part clock/epoch. Raises
    `TornSnapshot` when a part fails digest verification and
    FileNotFoundError when no complete manifest exists."""
    man = manifest if manifest is not None else read_manifest(base)
    if not complete(man):
        raise FileNotFoundError(f"no complete snapshot manifest at "
                                f"{manifest_path(base)}")
    world = int(man["world"])
    full_rows = {k: int(v) for k, v in man.get("full_rows", {}).items()}
    loaded: dict[int, dict] = {}

    def part(rank: int) -> dict:
        if rank not in loaded:
            loaded[rank] = read_part(base, man, rank)
        return loaded[rank]

    out: dict[str, np.ndarray] = {}
    for t, (lo, hi) in want.items():
        rows = full_rows.get(t)
        if rows is None:
            raise KeyError(f"table {t!r} not in snapshot manifest "
                           f"(has {sorted(full_rows)})")
        pieces = []
        for r in range(world):
            plo, phi = shard_range(rows, r, world)
            if phi <= lo or plo >= hi:
                continue
            a = part(r)[t]
            pieces.append(a[max(lo, plo) - plo:min(hi, phi) - plo])
        out[t] = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
    meta = {
        "version": int(man["version"]),
        "world": world,
        "full_rows": full_rows,
        "clock": max(int(p["clock"]) for p in man["parts"].values()),
        "epoch": max(int(p["epoch"]) for p in man["parts"].values()),
    }
    return out, meta


def write_snapshot_set(base: str, tables: dict[str, np.ndarray],
                       world: int = 1, clock: int = 0, epoch: int = 0,
                       compressed: bool = True) -> int:
    """Write a full snapshot set (parts + manifest) from in-memory full
    tables — the producer side of the ps_server snapshot format, for
    tools/serve_lab, benches, and tests that need a model on disk
    without running a training job. All parts land on disk first, then
    ONE manifest commit publishes the whole set (+1 version bump) — a
    reader mid-window either sees the old manifest (whose digests flag
    the replaced files as TornSnapshot, so it retries) or the new set,
    never a mix. Returns the committed version."""
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    full_rows = {k: int(v.shape[0]) for k, v in tables.items()}
    entries = {}
    for r in range(world):
        arrays = {}
        for k, v in tables.items():
            lo, hi = shard_range(full_rows[k], r, world)
            arrays[k] = np.ascontiguousarray(v[lo:hi], np.float32)
        meta = {"clock": int(clock), "epoch": int(epoch), "world": world,
                "full_rows": full_rows, "derived": {}, "last_seq": {},
                "full_shapes": {k: list(v.shape) for k, v in tables.items()},
                "zero_flags": None}
        arrays["__snap__"] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8).copy()
        path = part_name(base, None, r) + ".npz"
        atomic_savez(path, compressed=compressed, **arrays)
        entries[r] = {"file": os.path.basename(path),
                      "digest": file_digest(path),
                      "clock": int(clock), "epoch": int(epoch)}
    return commit_manifest_set(base, world, entries, full_rows)
