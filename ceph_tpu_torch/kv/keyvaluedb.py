"""KeyValueDB interface + MemDB backend.

Port of ``ceph_tpu/kv/keyvaluedb.py``.

Reference: src/kv/KeyValueDB.h -- prefixed keyspaces, batched atomic
transactions (set/rmkey/rmkeys_by_prefix), whole-prefix iteration; MemDB
(src/kv/MemDB.cc) is the RAM backend.  Keys are (prefix, key) string
pairs exactly as in the reference; values are bytes.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple


class KVTransaction:
    """A batch of mutations applied atomically by submit_transaction."""

    def __init__(self) -> None:
        #: ordered ops: ("set", prefix, key, value) | ("rm", prefix, key)
        #: | ("rm_prefix", prefix)
        self.ops: List[tuple] = []

    def set(self, prefix: str, key: str, value: bytes) -> "KVTransaction":
        self.ops.append(("set", prefix, key, bytes(value)))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rm", prefix, key))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rm_prefix", prefix))
        return self


class KeyValueDB:
    """Abstract store: open/close, point get, sorted iteration, atomic
    batched writes."""

    def open(self) -> None:  # mount/replay
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def submit_transaction(self, txn: KVTransaction, sync: bool = False) -> None:
        raise NotImplementedError

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def get_iterator(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        """Sorted (key, value) pairs under ``prefix``."""
        raise NotImplementedError


class MemDB(KeyValueDB):
    def __init__(self) -> None:
        self._data: Dict[Tuple[str, str], bytes] = {}

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def submit_transaction(self, txn: KVTransaction, sync: bool = False) -> None:
        for op in txn.ops:
            if op[0] == "set":
                self._data[(op[1], op[2])] = op[3]
            elif op[0] == "rm":
                self._data.pop((op[1], op[2]), None)
            elif op[0] == "rm_prefix":
                for pk in [pk for pk in self._data if pk[0] == op[1]]:
                    del self._data[pk]

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        return self._data.get((prefix, key))

    def get_iterator(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        keys = sorted(k for p, k in self._data if p == prefix)
        for k in keys:
            yield k, self._data[(prefix, k)]
