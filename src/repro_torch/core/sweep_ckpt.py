"""Journaled sweep checkpoints: kill-and-resume with bitwise-identical results.

A long DSE sweep (the ROADMAP's "week-long sweeps that survive preemption")
must not lose finished work to a kill. ``SweepCheckpoint`` journals each
completed memo key's embedding stats to an append-only file in
cadence-sized rounds; a restarted ``sweep(..., checkpoint=...)`` restores
journaled keys and evaluates only the remainder. The resumed ``SweepResult``
is **bitwise identical** to an uninterrupted run (differential-enforced),
which constrains the format:

  * **Exact numeric round-trip** — stats fields can hold numpy scalars from
    the device pipeline (e.g. f32 finish-cycle chains), and downstream
    arithmetic (``assemble_result``) is dtype-sensitive. Floats journal via
    JSON ``repr`` (exact for every finite double; f32 embeds exactly in
    f64), numpy scalars additionally carry a dtype tag and restore as the
    same ``np.dtype`` scalar.
  * **Torn-write detection** — each journal line is ``payload \t crc32 \n``.
    On open, the journal replays until the FIRST invalid line (bad CRC,
    truncated tail, malformed JSON) and truncates the file there: the keys
    on the torn tail are simply re-evaluated, never silently skipped or
    half-restored. (A sha256-verified torn-checkpoint rejection, adapted to
    an append-only journal.)
  * **Fingerprint guard** — the header pins a sha256 over everything that
    determines sweep *results* (workloads, base hardware, seed, grid,
    index trace, energy table — not the batching/sharding knobs, which are
    bit-exact). Resuming against a different sweep spec raises instead of
    mixing incompatible stats.
  * **Concurrent-writer guard** — an append-only journal written by two
    processes interleaves frames from different rounds and neither writer
    knows. ``open()`` takes a PID lockfile (``<path>.lock``) and raises
    ``CheckpointLockedError`` while another *live* process holds it; locks
    left by dead processes (a killed sweep) are taken over automatically,
    so kill-and-resume needs no manual cleanup.

The journal is engine-level (memo keys, not ``SweepEntry`` rows) so a
resumed sweep re-derives entries through the exact same assembly path as a
fresh one — including memo-key collapses added later in the run.

The format, the memo keys and the fingerprint are the JAX package's
(``repro.core.sweep_ckpt``), field for field: a journal written by either
package's sweep resumes in the other's.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from dataclasses import fields
from typing import Dict, List, Optional

import numpy as np

from .faults import CheckpointLockedError, InjectedKill
from .memory.system import CoreBatchStats, EmbeddingBatchStats

_VERSION = 1


def _pid_alive(pid: int) -> bool:
    """Best-effort liveness probe (same host; signal 0)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        # EPERM etc.: the process exists but isn't ours.
        return True
    return True


# --------------------------------------------------------------------------
# Exact-round-trip serialization
# --------------------------------------------------------------------------

def _enc_num(v):
    """Encode one numeric field preserving its exact type and bits."""
    if isinstance(v, np.generic):
        # Dtype tag -> restore as the same numpy scalar. .item() is exact
        # (f32 -> f64 embed; ints exact), repr round-trips the double.
        return {"__np__": v.dtype.str, "v": v.item()}
    return v


def _dec_num(v):
    if isinstance(v, dict) and "__np__" in v:
        return np.dtype(v["__np__"]).type(v["v"])
    return v


def _enc_stats(stats: List[List[EmbeddingBatchStats]]) -> list:
    out = []
    for per_batch in stats:
        rows = []
        for s in per_batch:
            d = {f.name: _enc_num(getattr(s, f.name))
                 for f in fields(EmbeddingBatchStats) if f.name != "per_core"}
            if s.per_core is not None:
                d["per_core"] = [
                    {f.name: _enc_num(getattr(c, f.name))
                     for f in fields(CoreBatchStats)}
                    for c in s.per_core
                ]
            rows.append(d)
        out.append(rows)
    return out


def _dec_stats(data: list) -> List[List[EmbeddingBatchStats]]:
    out = []
    for rows in data:
        per_batch = []
        for d in rows:
            per_core = None
            if "per_core" in d:
                per_core = [
                    CoreBatchStats(**{k: _dec_num(v) for k, v in c.items()})
                    for c in d["per_core"]
                ]
            kw = {k: _dec_num(v) for k, v in d.items() if k != "per_core"}
            per_batch.append(EmbeddingBatchStats(per_core=per_core, **kw))
        out.append(per_batch)
    return out


def _canon(obj):
    """Memo keys / fingerprints -> a canonical JSON-able value. Tuples become
    lists, numpy scalars their items; anything non-primitive falls back to
    ``repr`` (only equality between runs of the same spec matters)."""
    if isinstance(obj, (tuple, list)):
        return [_canon(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, np.generic):
        obj = obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


def _key_str(slice_id: tuple, key: tuple) -> str:
    return json.dumps(_canon([list(slice_id), list(key)]),
                      separators=(",", ":"), sort_keys=True)


def fingerprint_digest(desc: Dict) -> str:
    import hashlib

    text = json.dumps(_canon(desc), separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()


# --------------------------------------------------------------------------
# The journal
# --------------------------------------------------------------------------

class SweepCheckpoint:
    """Append-only, CRC-framed, fingerprint-guarded memo-key journal.

    Usage (``sweep()`` drives all of this when given ``checkpoint=``)::

        ckpt = SweepCheckpoint("results/sweep.ckpt", cadence=16)
        result = sweep(wls, hw, ..., checkpoint=ckpt)   # journals as it goes
        # ... kill at any point; rerun the same call to resume ...
    """

    def __init__(self, path: str, cadence: int = 16):
        self.path = str(path)
        # Memo keys per journal flush round: small -> finer resume
        # granularity, large -> fewer fsync-free appends. Rounds also bound
        # the shard dispatch size, so cadence trades resumability against
        # batching width.
        self.cadence = int(cadence)
        self._fh = None
        self._restored: Dict[str, List[List[EmbeddingBatchStats]]] = {}
        self.completed_entries: Optional[int] = None
        self._lock_owned = False
        # Test-only torn-write injection hook; sweep() installs its
        # FaultInjector here when given a fault_plan (None in production).
        self.fault_injector = None

    # -- concurrent-writer lockfile ---------------------------------------

    @property
    def lock_path(self) -> str:
        return self.path + ".lock"

    def _lock_holder(self) -> Optional[int]:
        try:
            with open(self.lock_path, "rb") as f:
                return int(json.loads(f.read().decode()).get("pid", -1))
        except (OSError, ValueError, json.JSONDecodeError,
                UnicodeDecodeError, AttributeError):
            return None

    def _acquire_lock(self) -> None:
        """Take ``<path>.lock`` via O_EXCL creation. A lock held by a live
        foreign process raises ``CheckpointLockedError`` (two writers would
        interleave appends). Stale locks — dead PID, unreadable payload, or
        our own PID (a prior open in this process that never closed, e.g. a
        killed-and-resumed sweep holding the same instance) — are taken
        over; O_EXCL arbitrates takeover races."""
        if self._lock_owned:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = json.dumps({
            "pid": os.getpid(),
            "path": os.path.abspath(self.path),
            "time": time.time(),
        }).encode()
        for _ in range(16):
            try:
                fd = os.open(self.lock_path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            except FileExistsError:
                pid = self._lock_holder()
                if pid is not None and pid != os.getpid() and _pid_alive(pid):
                    raise CheckpointLockedError(
                        f"checkpoint journal {self.path} is locked by live "
                        f"process {pid} ({self.lock_path}); two concurrent "
                        "writers would interleave appends — wait for it, or "
                        "remove the lockfile if you are certain it is stale")
                try:
                    os.unlink(self.lock_path)
                except FileNotFoundError:
                    pass
                continue
            try:
                os.write(fd, payload)
            finally:
                os.close(fd)
            self._lock_owned = True
            return
        raise CheckpointLockedError(
            f"could not acquire {self.lock_path} after repeated takeovers")

    def _release_lock(self) -> None:
        if self._lock_owned:
            self._lock_owned = False
            try:
                os.unlink(self.lock_path)
            except FileNotFoundError:
                pass

    # -- framing ----------------------------------------------------------

    @staticmethod
    def _frame(record: Dict) -> bytes:
        payload = json.dumps(record, separators=(",", ":"), sort_keys=True)
        crc = zlib.crc32(payload.encode()) & 0xFFFFFFFF
        return f"{payload}\t{crc:08x}\n".encode()

    @staticmethod
    def _parse_line(raw: bytes) -> Optional[Dict]:
        """One journal line -> record, or None when invalid/torn."""
        if not raw.endswith(b"\n"):
            return None                      # torn tail (no terminator)
        body = raw[:-1]
        sep = body.rfind(b"\t")
        if sep < 0:
            return None
        payload, crc_hex = body[:sep], body[sep + 1:]
        try:
            if zlib.crc32(payload) & 0xFFFFFFFF != int(crc_hex, 16):
                return None
        except ValueError:
            return None
        try:
            rec = json.loads(payload.decode())
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        return rec if isinstance(rec, dict) else None

    # -- lifecycle --------------------------------------------------------

    def open(self, fingerprint_desc: Dict) -> None:
        """Replay the journal (if any), validate the fingerprint, truncate
        any torn tail, and open for appending. Idempotent: re-opening (e.g.
        one ``SweepCheckpoint`` instance across several ``sweep()`` calls)
        re-replays from disk. Raises ``CheckpointLockedError`` while another
        live process holds the journal's lockfile."""
        self.close()
        self._acquire_lock()
        try:
            self._open_locked(fingerprint_desc)
        except BaseException:
            # open() is called before sweep()'s try/finally: failing here
            # (fingerprint mismatch, IO error) must not leave a lock that
            # only process death would clear.
            self._release_lock()
            raise

    def _open_locked(self, fingerprint_desc: Dict) -> None:
        digest = fingerprint_digest(fingerprint_desc)
        self._restored.clear()
        self.completed_entries = None
        valid_bytes = 0
        have_header = False
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                for raw in f:
                    rec = self._parse_line(raw)
                    if rec is None:
                        break                 # torn/corrupt: drop this + rest
                    if not have_header:
                        if rec.get("kind") != "header":
                            break
                        if rec.get("version") != _VERSION:
                            break             # unknown format: start over
                        if rec.get("fingerprint") != digest:
                            raise ValueError(
                                "checkpoint fingerprint mismatch: "
                                f"{self.path} was written by a different "
                                "sweep spec (workloads/hardware/seed/grid); "
                                "delete it or point at a fresh path"
                            )
                        have_header = True
                    elif rec.get("kind") == "key":
                        try:
                            stats = _dec_stats(rec["stats"])
                        except (KeyError, TypeError, ValueError):
                            break             # undecodable: treat as torn
                        self._restored[rec["k"]] = stats
                    elif rec.get("kind") == "complete":
                        self.completed_entries = rec.get("entries")
                    valid_bytes += len(raw)
        if have_header:
            # Keep the valid prefix; any torn tail is re-evaluated.
            if os.path.getsize(self.path) != valid_bytes:
                with open(self.path, "r+b") as f:
                    f.truncate(valid_bytes)
            self._fh = open(self.path, "ab")
        else:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "wb")
            self._fh.write(self._frame({
                "kind": "header", "version": _VERSION, "fingerprint": digest,
            }))
            self._fh.flush()
            os.fsync(self._fh.fileno())

    @property
    def restored_count(self) -> int:
        return len(self._restored)

    def lookup(self, slice_id: tuple, key: tuple):
        return self._restored.get(_key_str(slice_id, key))

    def record(self, slice_id: tuple, results: Dict[tuple, list]) -> None:
        """Journal one evaluation round (``sweep()`` calls this per cadence
        chunk). Flushed to the OS per round so a process kill loses at most
        the round in flight; fsync waits for ``mark_complete``/``close``."""
        if self._fh is None:
            raise RuntimeError("checkpoint not open")
        inj = self.fault_injector
        tear = inj is not None and results and inj.maybe_tear()
        items = list(results.items())
        for i, (key, stats) in enumerate(items):
            ks = _key_str(slice_id, key)
            frame = self._frame({
                "kind": "key", "k": ks, "stats": _enc_stats(stats),
            })
            if tear and i == len(items) - 1:
                # Injected torn write: half of the final frame reaches the
                # OS, then the "process" dies — exactly what a SIGKILL
                # mid-append leaves behind. Replay must truncate here and
                # re-evaluate this key (InjectedKill subclasses
                # KeyboardInterrupt so nothing downstream absorbs it).
                self._fh.write(frame[: max(1, len(frame) // 2)])
                self._fh.flush()
                raise InjectedKill(
                    f"injected torn journal write at {self.path}")
            self._fh.write(frame)
            self._restored[ks] = stats
        self._fh.flush()

    def mark_complete(self, num_entries: int) -> None:
        if self._fh is None:
            raise RuntimeError("checkpoint not open")
        self.completed_entries = int(num_entries)
        self._fh.write(self._frame({
            "kind": "complete", "entries": int(num_entries),
        }))
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        self._release_lock()

    def __enter__(self) -> "SweepCheckpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
