"""Mutable triple store: delta overlays + WAL + crash-consistent
compaction (DESIGN.md §9).

Mirrors the HBase storage model the source paper sits on:

  * **memstore analog** — per-index sorted delta overlays held on the
    host, disjoint from the base by construction (RDF set semantics);
    every refresh merges overlay keys into per-shard sorted rows and a
    globally sorted flat view on the store's device
    (``store/merge.py``), so the query and serving paths see ONE sorted
    index and need no code changes;
  * **WAL** — every ingest batch is framed, checksummed, and fsynced
    (``store/wal.py``) BEFORE it is applied; acknowledged == fsynced;
  * **flush / compaction** — when any shard's overlay exceeds
    ``overlay_limit``, the overlay is merged into the base, snapshotted
    to disk, and the WAL rotated — each step ordered so that a crash at
    ANY point recovers to a store whose query results equal a fresh
    ``build_store`` over the acked triples;
  * **versioned invalidation** — every applied mutation calls
    ``bump_version()``: ``store_version`` advances, ``plan_cache`` (host
    key copies, statistics, compiled plans and cascades) is dropped
    wholesale, and ``layout_key`` changes so the serving engine's
    compile/signature caches miss instead of serving rows from a
    pre-ingest world.

Where the data lives: the host keeps the numpy base and overlay of each
index (the snapshot, WAL replay and set-semantics dedup read them); the
device keeps a copy of each base, uploaded once per compaction or
recovery, and the merged rows, splits, counts and flat views, rebuilt
from the base copy and the uploaded overlay after every applied
mutation.

Shape discipline: the merged rows are ``(num_shards, base_cap +
ovl_cap)`` where ``ovl_cap`` is the CURRENT max per-shard overlay depth
rounded up on the planner's ``{2^k, 3*2^(k-1)}`` quantize grid — overlay
growth re-pads on grid steps only, and the flush threshold bounds
``ovl_cap`` from above.

Global-sortedness subtlety: the per-shard merged rows carry INF padding
at the END OF EVERY ROW (overlay headroom), so ``keys().reshape(-1)`` is
NOT globally sorted the way the immutable store's is. The local
executor, the planner's host statistics, and the batched local cascade
all search ``flat_keys`` — this class therefore OVERRIDES ``flat_keys``
with the separately built globally sorted flat view (all real keys
ascending, single INF tail).

On-disk layout, ordering of ack, flush and commit, and every index array
equal the JAX package's ``repro.store.mutable``: a store directory
written by either package recovers in the other to the same arrays.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core.rdf import MAX_ID, Dictionary, pack3
from repro_torch.core.triple_store import SPO, LRUCache, TripleStore
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.store.merge import base_layout, merge_index, route_counts
from repro_torch.store.wal import (REC_DICT, REC_TRIPLES, WalWriter,
                                   decode_dict_payload,
                                   decode_triples_payload,
                                   encode_dict_payload,
                                   encode_triples_payload, read_wal)

MANIFEST = "MANIFEST.json"


def _fsync_dir(path: str) -> None:
    """Make a rename in `path` durable (POSIX: fsync the directory)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_manifest(root: str, manifest: dict) -> None:
    """Atomic MANIFEST update: tmp + fsync + os.replace + dir fsync. A
    crash leaves either the old or the new manifest, never a torn one —
    the manifest is the single commit point of a flush."""
    tmp = os.path.join(root, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, MANIFEST))
    _fsync_dir(root)


def _read_manifest(root: str) -> dict:
    with open(os.path.join(root, MANIFEST)) as f:
        return json.load(f)


def _terms_to_arrays(terms: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Dictionary terms -> (lengths, utf8 blob) — npz-storable without
    pickle (object arrays would need allow_pickle on load)."""
    raw = [t.encode("utf-8") for t in terms]
    lens = np.array([len(r) for r in raw], np.int64)
    blob = np.frombuffer(b"".join(raw), np.uint8) if raw else \
        np.zeros(0, np.uint8)
    return lens, blob


def _terms_from_arrays(lens: np.ndarray, blob: np.ndarray) -> list[str]:
    out, off, data = [], 0, blob.tobytes()
    for ln in lens:
        out.append(data[off:off + int(ln)].decode("utf-8"))
        off += int(ln)
    return out


class MutableTripleStore(TripleStore):
    """`TripleStore` whose contents can grow at runtime, durably.

    Construct via :meth:`create` (fresh directory) or :meth:`open`
    (recovery: snapshot + WAL replay). All `TripleStore` consumers work
    unchanged — the dataclass fields always hold the CURRENT merged
    view, and `layout_key` carries `store_version` so caches keyed on
    the store can never cross a mutation.
    """

    def __init__(self, root: str, num_shards: int, overlay_limit: int,
                 dictionary: Dictionary, wal_writer: WalWriter,
                 base_spo: np.ndarray, base_ops: np.ndarray,
                 overlay_spo: np.ndarray, overlay_ops: np.ndarray,
                 init_version: int, metrics=None, device="cuda"):
        self.root = root
        self.overlay_limit = int(overlay_limit)
        self.dictionary = dictionary
        self._wal = wal_writer
        self._num_shards = int(num_shards)
        self._device = resolve_device(device, "MutableTripleStore")
        # overlay: 1-D sorted unique int64, disjoint from the base
        self._ov_spo = np.asarray(overlay_spo, np.int64)
        self._ov_ops = np.asarray(overlay_ops, np.int64)
        self._set_base(base_spo, base_ops)
        self._metrics = NULL_REGISTRY if metrics is None else metrics
        self.flush_count = 0
        TripleStore.__init__(
            self, **self._merged_arrays(),
            n_triples=len(self._bk_spo) + len(self._ov_spo),
            store_version=int(init_version), plan_cache=LRUCache())
        self._publish_metrics()

    # ------------------------------------------------------------------
    # construction / recovery
    # ------------------------------------------------------------------

    @classmethod
    def create(cls, root: str, num_shards: int = 1,
               overlay_limit: int = 4096, dictionary: Dictionary | None = None,
               fault_plan=None, metrics=None,
               device="cuda") -> "MutableTripleStore":
        """Initialize an empty durable store in `root` (created if needed;
        must not already hold a store). The index tensors go to `device`;
        the default is the card, and asking for it on a host without CUDA
        raises."""
        device = resolve_device(device, "MutableTripleStore.create")
        os.makedirs(root, exist_ok=True)
        if os.path.exists(os.path.join(root, MANIFEST)):
            raise ValueError(f"{root} already holds a store; use open()")
        manifest = {"format": 1, "num_shards": int(num_shards),
                    "snapshot": None, "wal": "wal-0.log", "start_seq": 0}
        _write_manifest(root, manifest)
        writer = WalWriter(os.path.join(root, manifest["wal"]),
                           start_seq=0, fault_plan=fault_plan)
        empty = np.zeros(0, np.int64)
        return cls(root, num_shards, overlay_limit,
                   dictionary or Dictionary(), writer,
                   empty, empty, empty, empty,
                   init_version=0, metrics=metrics, device=device)

    @classmethod
    def open(cls, root: str, overlay_limit: int = 4096,
             fault_plan=None, metrics=None,
             device="cuda") -> "MutableTripleStore":
        """Recover the store in `root`: load the snapshot, replay the
        WAL's durable prefix (torn tail truncated), rebuild the overlay.
        Read-only with respect to acked state — recovery never invents
        or drops an acknowledged triple, so results are bit-identical to
        `build_store` over the acked set. Recovery wall time, the device
        views included, is published as the `store_recovery_seconds`
        gauge."""
        device = resolve_device(device, "MutableTripleStore.open")
        t0 = time.perf_counter()
        manifest = _read_manifest(root)
        num_shards = int(manifest["num_shards"])
        start_seq = int(manifest["start_seq"])
        dictionary = Dictionary()
        base_spo = np.zeros(0, np.int64)
        base_ops = np.zeros(0, np.int64)
        if manifest["snapshot"]:
            with np.load(os.path.join(root, manifest["snapshot"])) as snap:
                base_spo = snap["keys_spo"].astype(np.int64)
                base_ops = snap["keys_ops"].astype(np.int64)
                terms = _terms_from_arrays(snap["term_lens"],
                                           snap["term_blob"])
            for i, t in enumerate(terms):
                dictionary.replay_term(i, t)
        # WalWriter repairs the torn tail, then we replay what survived
        writer = WalWriter(os.path.join(root, manifest["wal"]),
                           start_seq=start_seq, fault_plan=fault_plan)
        records, _, last_seq = read_wal(os.path.join(root, manifest["wal"]),
                                        start_seq=start_seq)
        replayed = []
        for _seq, rec_type, payload in records:
            if rec_type == REC_DICT:
                for idx, term in decode_dict_payload(payload):
                    dictionary.replay_term(idx, term)
            elif rec_type == REC_TRIPLES:
                replayed.append(decode_triples_payload(payload))
        ov_spo = np.zeros(0, np.int64)
        ov_ops = np.zeros(0, np.int64)
        if replayed:
            tri = np.concatenate(replayed)
            s, p, o = tri[:, 0], tri[:, 1], tri[:, 2]
            k_spo = np.unique(pack3(s, p, o))
            k_ops = np.unique(pack3(o, p, s))
            # overlay holds only what the base does not (set semantics)
            ov_spo = k_spo[~_sorted_isin(k_spo, base_spo)]
            ov_ops = k_ops[~_sorted_isin(k_ops, base_ops)]
        store = cls(root, num_shards, overlay_limit, dictionary, writer,
                    base_spo, base_ops, ov_spo, ov_ops,
                    init_version=last_seq + 1, metrics=metrics,
                    device=device)
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)
        store._metrics.gauge("store_recovery_seconds").set(
            time.perf_counter() - t0)
        return store

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def ingest(self, triples: np.ndarray) -> int:
        """Durably ingest an (N, 3) int id-triple batch: WAL append +
        fsync (the ack point), then apply to the overlay, flushing first
        if the overlay would exceed its per-shard limit. Returns the WAL
        sequence number the batch was acknowledged at. Re-ingesting an
        existing triple is a no-op for content (RDF set semantics)."""
        triples = np.asarray(triples, np.int64).reshape(-1, 3)
        self._validate(triples)
        self._flush_if_needed(triples)
        seq = self._wal.append(REC_TRIPLES,
                               encode_triples_payload(triples))
        self._wal.sync()          # <-- acknowledged
        self._apply(triples)
        self._metrics.counter("store_ingest_batches_total").inc()
        self._metrics.counter("store_ingest_triples_total").inc(
            len(triples))
        self._publish_metrics()
        return seq

    def ingest_terms(self, term_triples) -> int:
        """Durably ingest (s, p, o) STRING triples: newly minted
        dictionary entries and the encoded triples land in the same
        synced WAL write, so the dictionary grows without a rebuild and
        replay always defines a term before any triple references it."""
        before = len(self.dictionary)
        encoded = self.dictionary.encode_triples(term_triples)
        new_terms = [(i, self.dictionary.term(i))
                     for i in range(before, len(self.dictionary))]
        triples = np.asarray(encoded, np.int64).reshape(-1, 3)
        self._validate(triples)
        self._flush_if_needed(triples)
        if new_terms:
            self._wal.append(REC_DICT, encode_dict_payload(new_terms))
        seq = self._wal.append(REC_TRIPLES,
                               encode_triples_payload(triples))
        self._wal.sync()          # <-- acknowledged (terms + triples)
        self._apply(triples)
        self._metrics.counter("store_ingest_batches_total").inc()
        self._metrics.counter("store_ingest_triples_total").inc(
            len(triples))
        self._publish_metrics()
        return seq

    def flush(self) -> None:
        """Compact: merge the overlay into the base, snapshot, rotate the
        WAL, commit via the MANIFEST, then upload the new base to the
        device. Crash-safe at every step: until the manifest replace
        lands, recovery uses the old snapshot + old WAL; after it, the
        new snapshot + empty WAL — both describe the same acked set
        (replay is idempotent)."""
        new_spo = _merge_disjoint(self._bk_spo, self._ov_spo)
        new_ops = _merge_disjoint(self._bk_ops, self._ov_ops)
        seq = self._wal.next_seq
        snap_name = f"snap-{seq}.npz"
        wal_name = f"wal-{seq}.log"
        term_lens, term_blob = _terms_to_arrays(self.dictionary.terms())
        tmp = os.path.join(self.root, snap_name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, keys_spo=new_spo, keys_ops=new_ops,
                     term_lens=term_lens, term_blob=term_blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, snap_name))
        _fsync_dir(self.root)
        old_wal_path = self._wal.path
        fault_plan = self._wal.fault_plan
        self._wal.close()
        new_writer = WalWriter(os.path.join(self.root, wal_name),
                               start_seq=seq, fault_plan=fault_plan)
        manifest = _read_manifest(self.root)
        old_snap = manifest["snapshot"]
        manifest.update(snapshot=snap_name, wal=wal_name, start_seq=seq)
        _write_manifest(self.root, manifest)   # <-- commit point
        # post-commit garbage is best-effort: stale files are harmless
        # (recovery only reads what the manifest names)
        for stale in (old_wal_path,
                      os.path.join(self.root, old_snap) if old_snap else None):
            if stale and os.path.exists(stale):
                try:
                    os.remove(stale)
                except OSError:
                    pass
        self._wal = new_writer
        self._set_base(new_spo, new_ops)
        self._ov_spo = self._ov_spo[:0]
        self._ov_ops = self._ov_ops[:0]
        self.flush_count += 1
        self._metrics.counter("store_flush_total").inc()
        self._metrics.counter("store_compaction_total").inc()
        self._rebuild()
        self._publish_metrics()

    def close(self) -> None:
        self._wal.close()

    # ------------------------------------------------------------------
    # views / introspection
    # ------------------------------------------------------------------

    def flat_keys(self, index: int) -> torch.Tensor:
        """Globally sorted merged flat view (base ∪ overlay ascending,
        single INF tail, same total size as the padded shard rows). The
        override exists because the merged shard ROWS carry overlay
        headroom padding at every row tail — `reshape(-1)` of those is
        not globally sorted, and the planner's host statistics and the
        local cascades all binary-search a flat view. It is built with
        the rows at every refresh and kept out of `plan_cache`, which
        the refresh's version bump clears."""
        return self._flat[0 if index == SPO else 1]

    @property
    def overlay_depth(self) -> int:
        """Total overlay triples not yet compacted into the base."""
        return int(len(self._ov_spo))

    @property
    def wal_bytes(self) -> int:
        return self._wal.synced_bytes

    @property
    def acked_seq(self) -> int:
        """Highest acknowledged WAL sequence number (-1 if none ever)."""
        return self._wal.next_seq - 1

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _validate(self, triples: np.ndarray) -> None:
        if len(triples) == 0:
            raise ValueError("empty ingest batch")
        if triples.min() < 0 or triples.max() > MAX_ID:
            raise ValueError(f"triple ids must be in [0, {MAX_ID}]")
        if np.any(np.all(triples == MAX_ID, axis=1)):
            raise ValueError("triple (MAX_ID, MAX_ID, MAX_ID) packs to "
                             "the INF_KEY sentinel and cannot be stored")

    def _delta_keys(self, triples: np.ndarray):
        """(new_spo, new_ops): the batch's keys not already present in
        base or overlay (sorted, unique)."""
        s, p, o = triples[:, 0], triples[:, 1], triples[:, 2]
        k_spo = np.unique(pack3(s, p, o))
        k_ops = np.unique(pack3(o, p, s))
        new_spo = k_spo[~_sorted_isin(k_spo, self._bk_spo)]
        new_spo = new_spo[~_sorted_isin(new_spo, self._ov_spo)]
        new_ops = k_ops[~_sorted_isin(k_ops, self._bk_ops)]
        new_ops = new_ops[~_sorted_isin(new_ops, self._ov_ops)]
        return new_spo, new_ops

    def _flush_if_needed(self, triples: np.ndarray) -> None:
        """Overflow check BEFORE the batch's WAL record is written: if
        folding the batch would push any shard's overlay past the limit,
        compact the EXISTING overlay into the base first. Ordering
        matters for durability — flush rotates the WAL away, so the
        triggering batch's record must land in the post-flush WAL (the
        snapshot taken by the flush does not contain the batch). If the
        overlay is already empty — one batch alone exceeds the limit —
        flushing can't help; the quantized ovl_cap simply escalates a
        grid step for this epoch instead."""
        if self.overlay_depth == 0:
            return
        new_spo, new_ops = self._delta_keys(triples)
        ov_spo = _merge_disjoint(self._ov_spo, new_spo)
        ov_ops = _merge_disjoint(self._ov_ops, new_ops)
        if max(self._max_shard_depth(ov_spo, 0),
               self._max_shard_depth(ov_ops, 1)) > self.overlay_limit:
            self.flush()

    def _apply(self, triples: np.ndarray) -> None:
        """Fold an acked batch into the overlay (dedup against base and
        overlay: RDF set semantics)."""
        new_spo, new_ops = self._delta_keys(triples)
        if len(new_spo) == 0:
            return  # pure duplicates: acked, content unchanged, no bump
        self._ov_spo = _merge_disjoint(self._ov_spo, new_spo)
        self._ov_ops = _merge_disjoint(self._ov_ops, new_ops)
        self._rebuild()

    def _set_base(self, base_spo: np.ndarray, base_ops: np.ndarray) -> None:
        """Adopt a new base (sorted unique int64 per index): the host
        arrays, their shard layout (kept for the base's lifetime) and
        their one upload to the device."""
        self._bk_spo = np.asarray(base_spo, np.int64)
        self._bk_ops = np.asarray(base_ops, np.int64)
        self._layouts = tuple(base_layout(bk, self._num_shards)
                              for bk in (self._bk_spo, self._bk_ops))
        self._bk_dev = tuple(torch.from_numpy(bk).to(self._device)
                             for bk in (self._bk_spo, self._bk_ops))

    def _max_shard_depth(self, ov: np.ndarray, index: int) -> int:
        return int(route_counts(ov, self._layouts[index]).max())

    def _merged_arrays(self) -> dict:
        """Merged per-shard rows + region boundaries + counts for both
        indexes, built on the device, as the dataclass field dict; the
        flat views go to `_flat`."""
        out, flat = {}, []
        for i, (name, ov) in enumerate((("spo", self._ov_spo),
                                        ("ops", self._ov_ops))):
            rows, splits, counts, f = merge_index(
                self._bk_dev[i], self._layouts[i], ov)
            out.update({f"keys_{name}": rows, f"splits_{name}": splits,
                        f"counts_{name}": counts})
            flat.append(f)
        self._flat = tuple(flat)
        return out

    def _rebuild(self) -> None:
        """Re-materialize the dataclass fields from base + overlay and
        advance the version (the mutation barrier: every store-keyed
        cache misses from here on)."""
        for name, val in self._merged_arrays().items():
            setattr(self, name, val)
        self.n_triples = len(self._bk_spo) + len(self._ov_spo)
        self.bump_version()

    def _publish_metrics(self) -> None:
        m = self._metrics
        m.gauge("store_overlay_depth").set(self.overlay_depth)
        m.gauge("store_wal_bytes").set(self.wal_bytes)
        m.gauge("store_n_triples").set(self.n_triples)
        m.gauge("store_version").set(self.store_version)


def _sorted_isin(needles: np.ndarray, haystack: np.ndarray) -> np.ndarray:
    """Membership of sorted `needles` in sorted unique `haystack` —
    searchsorted, no hashing."""
    if len(haystack) == 0:
        return np.zeros(len(needles), bool)
    pos = np.searchsorted(haystack, needles)
    pos = np.minimum(pos, len(haystack) - 1)
    return haystack[pos] == needles


def _merge_disjoint(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted, mutually disjoint unique arrays (host)."""
    if len(a) == 0:
        return b.copy()
    if len(b) == 0:
        return a.copy()
    out = np.concatenate([a, b])
    out.sort()
    return out
