"""Paxos as the monitors run it: one leader, versioned committed values.

Port of ``ceph_tpu/mon/paxos.py``.

Reference: src/mon/Paxos.cc — phase 1 collect/last (recovery after
election), phase 2 begin/accept (one in-flight proposal at a time, the
"updating" state), commit broadcast; proposal numbers grow by 100 with the
proposer's rank in the low digits (Paxos::get_new_proposal_number).

The store is the MonitorDBStore analogue: a dict of version -> value with
last_committed/accepted_pn markers; every mutation lands there before a
message goes out, which is what makes crash-recovery sound.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class PaxosStore:
    values: Dict[int, dict] = field(default_factory=dict)
    last_committed: int = 0
    accepted_pn: int = 0
    # uncommitted value carried across recovery (Paxos.cc handle_last)
    uncommitted_v: Optional[int] = None
    uncommitted_value: Optional[dict] = None
    #: optional durable backing (MonitorDBStore over the LSM KeyValueDB;
    #: the reference's store.db RocksDB).  When attached, every paxos
    #: state change lands on disk before the next message goes out.
    db: object = None

    # kv layout: prefix "P" version -> value, prefix "T" paxos metadata
    def attach(self, db) -> None:
        from ceph_tpu_torch.utils.encoding import Decoder

        self.db = db
        for key, raw in db.get_iterator("P"):
            self.values[int(key)] = Decoder(raw).value()
        meta = db.get("T", "meta")
        if meta is not None:
            m = Decoder(meta).value()
            self.last_committed = m["last_committed"]
            self.accepted_pn = m["accepted_pn"]
            self.uncommitted_v = m["uncommitted_v"]
            self.uncommitted_value = m["uncommitted_value"]

    def persist_meta(self, txn=None) -> None:
        if self.db is None:
            return
        from ceph_tpu_torch.kv.keyvaluedb import KVTransaction
        from ceph_tpu_torch.utils.encoding import Encoder

        batch = txn or KVTransaction()
        batch.set("T", "meta", Encoder().value({
            "last_committed": self.last_committed,
            "accepted_pn": self.accepted_pn,
            "uncommitted_v": self.uncommitted_v,
            "uncommitted_value": self.uncommitted_value,
        }).bytes())
        if txn is None:
            self.db.submit_transaction(batch)

    def persist_commit(self, v: int) -> None:
        """Committed value + metadata in ONE batch (the reference's
        single MonitorDBStore transaction per commit)."""
        if self.db is None:
            return
        from ceph_tpu_torch.kv.keyvaluedb import KVTransaction
        from ceph_tpu_torch.utils.encoding import Encoder

        batch = KVTransaction()
        batch.set("P", str(v), Encoder().value(self.values[v]).bytes())
        self.persist_meta(batch)
        self.db.submit_transaction(batch)


class Paxos:
    """One monitor's paxos state machine.  Message I/O is delegated to the
    owning Monitor (send(rank, msg)); commit application via on_commit."""

    def __init__(
        self,
        rank: int,
        n_mons: int,
        send: Callable,
        on_commit: Callable[[int, dict], None],
    ):
        self.rank = rank
        self.n_mons = n_mons
        self.send = send
        self.on_commit = on_commit
        self.store = PaxosStore()
        self._accepts: set = set()
        self._lasts: Dict[int, dict] = {}
        self._proposal_done: Optional[asyncio.Future] = None
        self._collect_done: Optional[asyncio.Future] = None
        self._pending_value: Optional[dict] = None

    @property
    def majority(self) -> int:
        return self.n_mons // 2 + 1

    def new_pn(self) -> int:
        """reference: Paxos.cc get_new_proposal_number — multiple of 100
        plus rank, strictly above anything seen."""
        base = (self.store.accepted_pn // 100 + 1) * 100
        return base + self.rank

    # -- leader: recovery (phase 1) ---------------------------------------

    async def collect(self, quorum: List[int], timeout: float = 1.0) -> bool:
        """Run the collect/last round (retrying at a higher pn when a peon
        has promised a newer one — reference: handle_last's
        "uncommitted_pn > accepted_pn -> bootstrap" path); re-commits any
        uncommitted value learned from a peer.  True on success."""
        for _ in range(3):
            if await self._collect_once(quorum, timeout):
                return True
        return False

    async def _collect_once(self, quorum: List[int], timeout: float) -> bool:
        pn = self.new_pn()
        self.store.accepted_pn = pn
        self.store.persist_meta()
        self._lasts = {
            self.rank: {
                "last_committed": self.store.last_committed,
                "uncommitted_v": self.store.uncommitted_v,
                "uncommitted_value": self.store.uncommitted_value,
            }
        }
        self._collect_done = asyncio.get_event_loop().create_future()
        for r in quorum:
            if r != self.rank:
                await self.send(
                    r,
                    {
                        "type": "paxos_collect",
                        "pn": pn,
                        "last_committed": self.store.last_committed,
                    },
                )
        if len(self._lasts) < self.majority:
            try:
                ok = await asyncio.wait_for(self._collect_done, timeout)
            except asyncio.TimeoutError:
                return False
            if not ok:
                return False  # nacked: retry at a higher pn
        # adopt the newest uncommitted value seen (ours included)
        best = None
        for info in self._lasts.values():
            if info.get("uncommitted_v") is not None:
                if best is None or info["uncommitted_v"] > best[0]:
                    best = (info["uncommitted_v"], info["uncommitted_value"])
        if best is not None and best[0] == self.store.last_committed + 1:
            await self.propose(best[1], quorum)
        return True

    def handle_collect(self, src_rank: int, msg: dict) -> List[tuple]:
        """Peon side; returns [(rank, reply)] to send.  A stale pn gets a
        nack carrying our promised pn (so the caller can retry higher) but
        still shares committed values for catch-up."""
        reply = {
            "type": "paxos_last",
            "pn": msg["pn"],
            "last_committed": self.store.last_committed,
            "uncommitted_v": self.store.uncommitted_v,
            "uncommitted_value": self.store.uncommitted_value,
            "values": {
                v: self.store.values[v]
                for v in range(
                    msg["last_committed"] + 1, self.store.last_committed + 1
                )
                if v in self.store.values
            },
        }
        if msg["pn"] >= self.store.accepted_pn:
            self.store.accepted_pn = msg["pn"]
            self.store.persist_meta()
        else:
            reply["nack_pn"] = self.store.accepted_pn
        return [(src_rank, reply)]

    def handle_last(self, src_rank: int, msg: dict) -> List[tuple]:
        """Leader side; returns [(rank, msg)] share traffic to send.
        Catches up on commits the peer has and we lack AND shares our
        commits with a lagging peer (Paxos.cc share_state both ways --
        without the leader->peon half, a mon that missed commits while
        down would stay behind forever unless it won an election)."""
        for v, val in sorted(msg.get("values", {}).items()):
            v = int(v)
            if v == self.store.last_committed + 1:
                self._commit(v, val)
        if msg["pn"] != self.store.accepted_pn:
            return []  # stale round (incl. late nacks): ignore
        if "nack_pn" in msg:
            # a peon promised newer: adopt, so new_pn() goes above it and
            # the collect retry loop can win the next round
            if msg["nack_pn"] > self.store.accepted_pn:
                self.store.accepted_pn = msg["nack_pn"]
                self.store.persist_meta()
            if self._collect_done and not self._collect_done.done():
                self._collect_done.set_result(False)
            return []
        self._lasts[src_rank] = msg
        if (
            len(self._lasts) >= self.majority
            and self._collect_done
            and not self._collect_done.done()
        ):
            self._collect_done.set_result(True)
        out = []
        for v in range(int(msg["last_committed"]) + 1,
                       self.store.last_committed + 1):
            if v in self.store.values:
                out.append((src_rank, {
                    "type": "paxos_commit", "pn": msg["pn"],
                    "v": v, "value": self.store.values[v],
                }))
        return out

    # -- leader: proposal (phase 2) ---------------------------------------

    async def propose(
        self, value: dict, quorum: List[int], timeout: float = 1.0
    ) -> bool:
        """Begin/accept/commit one value at version last_committed+1."""
        v = self.store.last_committed + 1
        pn = self.store.accepted_pn
        # leader accepts its own proposal first (begin writes to store)
        self.store.uncommitted_v = v
        self.store.uncommitted_value = value
        self.store.persist_meta()
        self._accepts = {self.rank}
        self._proposal_done = asyncio.get_event_loop().create_future()
        for r in quorum:
            if r != self.rank:
                await self.send(
                    r,
                    {"type": "paxos_begin", "pn": pn, "v": v, "value": value},
                )
        if len(self._accepts) < self.majority:
            try:
                ok = await asyncio.wait_for(self._proposal_done, timeout)
            except asyncio.TimeoutError:
                return False
            if not ok:
                return False  # nacked: a newer pn exists; caller re-collects
        # majority accepted: commit locally and broadcast
        self._commit(v, value)
        for r in quorum:
            if r != self.rank:
                await self.send(
                    r, {"type": "paxos_commit", "pn": pn, "v": v, "value": value}
                )
        return True

    def handle_begin(self, src_rank: int, msg: dict) -> List[tuple]:
        if msg["pn"] < self.store.accepted_pn:
            # promised a newer leader: nack so the proposer re-collects
            return [
                (
                    src_rank,
                    {
                        "type": "paxos_accept",
                        "pn": msg["pn"],
                        "v": msg["v"],
                        "nack_pn": self.store.accepted_pn,
                    },
                )
            ]
        self.store.accepted_pn = msg["pn"]
        self.store.uncommitted_v = msg["v"]
        self.store.uncommitted_value = msg["value"]
        self.store.persist_meta()
        return [
            (src_rank, {"type": "paxos_accept", "pn": msg["pn"], "v": msg["v"]})
        ]

    def handle_accept(self, src_rank: int, msg: dict) -> None:
        if "nack_pn" in msg:
            if msg["nack_pn"] > self.store.accepted_pn:
                self.store.accepted_pn = msg["nack_pn"]
                self.store.persist_meta()
            if self._proposal_done and not self._proposal_done.done():
                self._proposal_done.set_result(False)
            return
        if msg["pn"] != self.store.accepted_pn:
            return
        if msg.get("v") != self.store.uncommitted_v:
            return  # delayed accept for an earlier value under the same pn
        self._accepts.add(src_rank)
        if (
            len(self._accepts) >= self.majority
            and self._proposal_done
            and not self._proposal_done.done()
        ):
            self._proposal_done.set_result(True)

    def handle_commit(self, src_rank: int, msg: dict) -> None:
        v = msg["v"]
        if v == self.store.last_committed + 1:
            self._commit(v, msg["value"])

    def _commit(self, v: int, value: dict) -> None:
        self.store.values[v] = value
        self.store.last_committed = v
        if self.store.uncommitted_v == v:
            self.store.uncommitted_v = None
            self.store.uncommitted_value = None
        # durable BEFORE application/broadcast (one MonitorDBStore batch)
        self.store.persist_commit(v)
        self.on_commit(v, value)
