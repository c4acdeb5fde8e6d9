"""Durable mutable storage: WAL + delta overlays + crash-consistent
compaction (DESIGN.md §9) — the HBase memstore/WAL/HFile analog under
the query stack, with the merged index views built on the store's
device."""
from repro_torch.store.mutable import MutableTripleStore
from repro_torch.store.wal import (REC_DICT, REC_TRIPLES, WalWriter, read_wal,
                                   scan_records)

__all__ = ["MutableTripleStore", "WalWriter", "read_wal", "scan_records",
           "REC_DICT", "REC_TRIPLES"]
