"""Deterministic fault injection: the sharded serving path's a2a answer
legs (DESIGN.md §7) and the mutable store's WAL (DESIGN.md §9).

A ``FaultPlan`` is a static, hashable description of which a2a ANSWER
legs misbehave and when: each ``Fault`` names the join step, the
answering shard, the kind (``drop`` — the shard's outgoing answer blocks
plus their checksums are zeroed, as if the packets were lost;
``corrupt`` — the answer keys are perturbed AFTER the checksum is
computed, i.e. wire corruption; ``delay`` — a host-side synthetic stall,
no device-side effect), and the dispatch **epoch** it fires on. The
engine counts physical dispatch attempts on a monotone epoch counter
(retries included), so a retry naturally advances past a one-shot fault;
``period > 0`` makes the schedule repeat (``epoch % period``), which is
how a sampled plan injects a steady background fault RATE.

Detection lives in ``core/distributed._dist_probe_a2a``: with
``with_check=True`` every answering shard ships a salted positional
checksum per outgoing answer block alongside the answer leg, and the
origin recomputes it over what actually arrived. A mismatched block is
ZEROED before any of its keys can enter a Bindings row (no wrong rows,
ever — at worst rows are missing pending the retry) and counted into
the ``bad`` output the engine's dispatch loop retries on.

A :class:`DurabilityFaultPlan` is a static, seedable schedule of WAL
faults: ``store.wal.WalWriter`` consults it on every record it appends
and every fsync, and the first fault that fires tears the record, drops
unsynced bytes and raises :class:`SimulatedCrash` before the ack.

Every plan is exactly reproducible from its arguments, or, via
``sample``, from a seed: the same draw as the JAX package's plan for the
same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("drop", "corrupt", "delay")


class SimulatedCrash(Exception):
    """Raised by durability fault injection at the exact byte boundary a
    real crash would occupy. The store object that raised it must be
    abandoned (as a dead process's heap would be) and re-opened from
    disk — recovery is the code under test."""


@dataclasses.dataclass(frozen=True)
class WalFault:
    """One injected durability fault, fired when WAL record `record` is
    appended (absolute sequence number — numbering continues across WAL
    rotations, so a fault can target a post-compaction record).

    Effect, in order:
      1. ``lose_unsynced`` — previously appended-but-unsynced bytes are
         discarded (a power loss before the page cache hit disk: the
         partial-fsync scenario);
      2. the first ``torn_bytes`` bytes of the new record's frame are
         written and made durable (a torn write — 0 means the record
         never reached disk at all);
      3. :class:`SimulatedCrash` is raised BEFORE the ack, so the
         injected record (and anything lost in step 1) was never
         acknowledged and recovery must not surface it.
    """
    record: int
    torn_bytes: int = 0
    lose_unsynced: bool = False


@dataclasses.dataclass(frozen=True)
class DurabilityFaultPlan:
    """Static, seedable schedule of WAL faults. Hooked by
    ``store.wal.WalWriter``: ``on_append`` is consulted per record,
    ``on_sync`` per fsync. The first firing fault raises
    :class:`SimulatedCrash` (a crashed process injects at most one
    crash), so a plan normally carries one fault."""
    faults: tuple[WalFault, ...] = ()

    def _find(self, seq: int) -> WalFault | None:
        for f in self.faults:
            if f.record == seq:
                return f
        return None

    def on_append(self, seq: int, rec: bytes, writer) -> bytes:
        """Called by WalWriter.append with the framed record bytes before
        they are written; returns them unchanged when no fault fires."""
        f = self._find(seq)
        if f is None:
            return rec
        if f.lose_unsynced:
            writer.drop_unsynced()
        torn = rec[:max(0, min(f.torn_bytes, len(rec)))]
        if torn:
            # the prefix that made it to disk before the lights went out
            writer._f.write(torn)
            writer._f.flush()
        writer._f.close()
        raise SimulatedCrash(
            f"crash at WAL record {seq} (torn_bytes={len(torn)}, "
            f"lose_unsynced={f.lose_unsynced})")

    def on_sync(self, writer) -> None:
        """Sync-time hook (a pass-through; crash points are expressed
        per-record via ``on_append``)."""

    def any_fault(self) -> bool:
        return bool(self.faults)

    @classmethod
    def sample(cls, seed: int, horizon: int = 16,
               max_torn: int = 64) -> "DurabilityFaultPlan":
        """One seeded crash somewhere in the next `horizon` records:
        uniformly chosen record, torn prefix length in [0, max_torn],
        fair-coin unsynced-byte loss. Deterministic from the seed."""
        rng = np.random.RandomState(seed)
        return cls((WalFault(record=int(rng.randint(horizon)),
                             torn_bytes=int(rng.randint(max_torn + 1)),
                             lose_unsynced=bool(rng.randint(2))),))


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault on a shard's a2a answer leg."""
    step: int                   # join-step index (0 = first join step)
    shard: int                  # answering shard whose leg misbehaves
    kind: str                   # drop | corrupt | delay
    epoch: int = 0              # dispatch-attempt sequence number it fires on
    delay_s: float = 0.0        # synthetic stall (kind == "delay" only)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A static, hashable schedule of injected faults.

    ``period > 0`` repeats the schedule every `period` epochs (faults
    match on ``epoch % period``); 0 means one-shot epochs. The plan's
    per-epoch selection is part of the engine's cascade-cache key, so it
    stays frozen and hashable."""
    faults: tuple[Fault, ...] = ()
    period: int = 0

    def _active(self, epoch: int):
        e = epoch % self.period if self.period > 0 else epoch
        return [f for f in self.faults if f.epoch == e]

    def at(self, epoch: int, step: int) -> tuple[tuple, tuple]:
        """(drop_shards, corrupt_shards) active for `step` at `epoch` —
        sorted tuples, the static per-step fault selection a dispatched
        cascade carries."""
        act = [f for f in self._active(epoch) if f.step == step]
        return (tuple(sorted(f.shard for f in act if f.kind == "drop")),
                tuple(sorted(f.shard for f in act if f.kind == "corrupt")))

    def selection(self, epoch: int, n_steps: int) -> tuple:
        """Per-join-step fault selection for one dispatch attempt: a
        hashable ``((drop...), (corrupt...))`` per step. All-empty on
        clean epochs."""
        return tuple(self.at(epoch, i) for i in range(n_steps))

    def delay_s_at(self, epoch: int) -> float:
        """Total synthetic stall injected at `epoch` (host-side: feeds
        the engine's dispatch watchdog and deadline accounting)."""
        return sum(f.delay_s for f in self._active(epoch)
                   if f.kind == "delay")

    def any_fault(self) -> bool:
        return bool(self.faults)

    @classmethod
    def sample(cls, seed: int, num_shards: int, n_steps: int = 2,
               rate: float = 0.01, horizon: int = 64,
               kinds: tuple[str, ...] = ("drop", "corrupt")) -> "FaultPlan":
        """Seeded Bernoulli(rate) fault per (epoch, step, shard) leg over
        a `horizon`-epoch repeating schedule — `rate` is the fraction of
        answer legs faulted in steady state. Deterministic: the same
        seed always yields the same plan."""
        rng = np.random.RandomState(seed)
        faults = []
        for e in range(horizon):
            for st in range(n_steps):
                for sh in range(num_shards):
                    if rng.rand() < rate:
                        faults.append(Fault(st, sh,
                                            kinds[rng.randint(len(kinds))],
                                            epoch=e))
        return cls(tuple(faults), period=horizon)
