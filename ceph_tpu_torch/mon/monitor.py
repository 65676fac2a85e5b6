"""Monitor daemon: election, paxos-replicated OSDMap, command handling.

Port of ``ceph_tpu/mon/monitor.py``.

Reference: src/mon/Monitor.cc (daemon + command dispatch),
src/mon/Elector.cc (rank-based election: lowest reachable rank wins),
src/mon/OSDMonitor.cc (profile set :5232, pool create :5529, get_erasure_code
:5353 — profiles validated by instantiating the plugin), map broadcast to
subscribers (Monitor::send_latest).  Clients may address any monitor;
non-leaders forward to the leader the way peons forward proposals.

A profile that names no plugin is validated with ``osd/cluster.py``'s
``DEFAULT_PLUGIN``, the card's (``cuda``; the JAX package's mon uses
``jerasure``).

One deliberate difference from the JAX package: a resent mutating
command is idempotent.  ``MonClient.command`` gives each command one
request id, ``(client name, incarnation, tid)``, and keeps it across
every resend to every mon (as the objecter keeps its reqid across
resends; the incarnation comes from a per-process counter seeded with
entropy, so two clients that share a name never mint one id).  A mon
keys each record on that id, bound to the authenticated caller (a reqid
whose name is not the caller's is dropped), and on a digest of the
command, so that a record answers only the command it was made for.
The final proposal of a mutating command carries the key and a
declarative answer (the ``answer`` of ``_commit``); every mon that
applies the commit records ``key -> (rc, out)`` in a bounded map (the
role of the PG log's dups), a mon that receives a command whose key is
recorded answers the record once the caller has passed the command's
cap check, and a proposal whose key was already applied (a resend that
raced the first commit) applies as a no-op.  Read-only commands propose nothing
and are not recorded.  The JAX package's client resends with a new id,
so a reply that comes late turns a committed ``osd add`` into -17
EEXIST there.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import hashlib
import itertools
import json
import os
from typing import Dict, List, Optional

from ceph_tpu_torch.mon.osdmap import OSDMap
from ceph_tpu_torch.mon.paxos import Paxos
import copy

from ceph_tpu_torch.mon.services import (AuthDB, ClusterLog,
                                         ConfigKeyStore, ConfigStore, FSMap,
                                         MgrMap)
from ceph_tpu_torch.osd.messenger import Messenger
from ceph_tpu_torch.utils.log import dout

#: the record key of the client command the current task executes (set
#: by ``Monitor._handle_command``, read by ``Monitor._propose``)
_RECORD_KEY: contextvars.ContextVar = contextvars.ContextVar(
    "mon_record_key", default=None)
#: applied command results each mon remembers (the reference's
#: osd_pg_log_dups_tracked default plays the same role for client ops)
REQIDS_TRACKED = 3000
#: per-process MonClient incarnation source, the reqid's middle field
#: (the objecter's ``_INCARNATIONS`` role): seeded with entropy, so that
#: a restarted client, or a second one under the same name, never
#: reuses a reqid another instance's command was recorded under
_INCARNATIONS = itertools.count(int.from_bytes(os.urandom(6), "big"))


def record_key(reqid, cmd: dict, caller: str) -> Optional[tuple]:
    """The key a mon records a command's result under: the client's
    ``(name, incarnation, tid)`` and a digest of ``cmd``.  None (the
    command is not recorded) without a well-formed reqid, or when its
    name is not ``caller``, the authenticated entity."""
    if not isinstance(reqid, (list, tuple)) or len(reqid) != 3 or \
            reqid[0] != caller:
        return None
    try:
        incarnation, tid = int(reqid[1]), int(reqid[2])
    except (TypeError, ValueError):
        return None
    digest = hashlib.sha256(json.dumps(
        cmd, sort_keys=True, default=repr).encode()).hexdigest()[:16]
    return (caller, incarnation, tid, digest)


class Monitor:
    def __init__(self, rank: int, n_mons: int, messenger: Messenger,
                 store_path: Optional[str] = None):
        self.rank = rank
        self.n_mons = n_mons
        self.name = f"mon.{rank}"
        self.messenger = messenger
        self.paxos = Paxos(rank, n_mons, self._send_to_rank, self._on_commit)
        self.osdmap = OSDMap()
        # the PaxosService family: slices of replicated state sharing
        # the one paxos instance (src/mon/PaxosService.h)
        self.kvstore = ConfigKeyStore()
        self.configdb = ConfigStore()
        self.clog = ClusterLog()
        self.authdb = AuthDB()
        self.mgrmap = MgrMap()
        self.fsmap = FSMap()
        #: leader-local beacon liveness (the reference keeps pending
        #: beacon state outside paxos too): daemon name -> last stamp
        self._beacons: Dict[str, float] = {}
        #: applied mutating commands: record key -> (rc, out), oldest
        #: first, at most REQIDS_TRACKED (rebuilt by the store replay
        #: below like every other slice of committed state)
        self._reqid_results: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self._store_db = None
        if store_path is not None:
            # MonitorDBStore role: paxos state on an LSM KeyValueDB; a
            # restarted mon rebuilds its services by replaying the
            # committed values (Monitor::preinit + PaxosService
            # update_from_paxos)
            from ceph_tpu_torch.kv.lsm import LSMStore

            self._store_db = LSMStore(store_path)
            self._store_db.open()
            self.paxos.store.attach(self._store_db)
            for v in sorted(self.paxos.store.values):
                if v <= self.paxos.store.last_committed:
                    self._apply_commit(self.paxos.store.values[v])
        self.leader: Optional[int] = None
        self.quorum: List[int] = []
        self.election_epoch = 0
        self._election_acks: set = set()
        self._election_done: Optional[asyncio.Future] = None
        self._subscribers: set = set()
        #: names spawned tasks uniquely (commands, subscriber pushes)
        self._cmd_seq = 0
        self._cmd_lock = asyncio.Lock()
        self._last_lease = 0.0
        #: pending OSD failure reports: osd id -> {reporter: stamp}
        #: (leader-local, like the reference's failure_info_t pending
        #: map).  Entries EXPIRE (see "osd failure" handling) so a
        #: reporter's one transient probe stall can never combine with an
        #: unrelated stall hours later to mark a healthy OSD down.
        self._failure_reports: Dict[int, Dict[str, float]] = {}
        messenger.register(self.name, self.dispatch)

    def close_store(self) -> None:
        """Release the durable store (a stopped mon; the tool can then
        open it offline)."""
        if self._store_db is not None:
            self._store_db.close()
            self._store_db = None
            self.paxos.store.db = None

    def start_tick(self, interval: float = 0.1, miss_factor: float = 4.0):
        """Lease probing (reference: Paxos lease extend/ack + Elector
        timers): peons probe the leader; on miss_factor*interval of
        silence they call an election."""
        loop = asyncio.get_event_loop()
        self._last_lease = loop.time()

        async def tick():
            while True:
                await asyncio.sleep(interval)
                if self.is_leader() or self.leader is None:
                    continue
                await self._send_to_rank(self.leader, {"type": "mon_lease_probe"})
                if loop.time() - self._last_lease > interval * miss_factor:
                    self._last_lease = loop.time()  # back off before retry
                    await self.start_election()

        self.messenger.adopt_task(f"{self.name}.tick", loop.create_task(tick()))

    # -- plumbing ----------------------------------------------------------

    async def _send_to_rank(self, rank: int, msg: dict) -> None:
        await self.messenger.send_message(self.name, f"mon.{rank}", msg)

    def is_leader(self) -> bool:
        return self.leader == self.rank

    @property
    def majority(self) -> int:
        return self.n_mons // 2 + 1

    # -- election (Elector.cc analogue) ------------------------------------

    async def start_election(self, timeout: float = 0.5) -> bool:
        """Propose self; lower-rank live mons preempt (they nack and run
        their own).  Victory on majority of defer-acks."""
        self.election_epoch += 1
        self.leader = None
        self._election_acks = {self.rank}
        self._election_done = asyncio.get_event_loop().create_future()
        for r in range(self.n_mons):
            if r != self.rank:
                await self._send_to_rank(
                    r, {"type": "election_propose", "epoch": self.election_epoch}
                )
        if len(self._election_acks) < self.majority:
            try:
                await asyncio.wait_for(self._election_done, timeout)
            except asyncio.TimeoutError:
                return False
        if self.leader is not None and self.leader != self.rank:
            return False  # preempted by a lower rank mid-election
        quorum = sorted(self._election_acks)
        for r in range(self.n_mons):
            if r != self.rank:
                await self._send_to_rank(
                    r,
                    {
                        "type": "election_victory",
                        "epoch": self.election_epoch,
                        "leader": self.rank,
                        "quorum": quorum,
                    },
                )
        if self.leader is not None and self.leader != self.rank:
            # a lower rank's victory landed while we were broadcasting
            # ours: writing self.rank here would clobber the real leader
            # (asyncsan rmw-across-await: the victory sends above yield)
            return False
        self.leader = self.rank
        self.quorum = quorum
        # recovery: bring the quorum's stores into agreement
        await self.paxos.collect(quorum)
        dout("mon", 5, f"{self.name} won election epoch {self.election_epoch}")
        return True

    async def _handle_election(self, src: str, msg: dict) -> None:
        src_rank = int(src.split(".")[1])
        t = msg["type"]
        if t == "election_propose":
            if msg["epoch"] > self.election_epoch:
                self.election_epoch = msg["epoch"]
            if src_rank < self.rank:
                # defer to the lower rank
                await self._send_to_rank(
                    src_rank,
                    {"type": "election_ack", "epoch": msg["epoch"]},
                )
            else:
                # I outrank them: run my own election (spawned -- it
                # awaits acks that arrive through this dispatch loop;
                # adopt_task retains it and logs a crash).  Unique name:
                # re-using one would untrack a still-running
                # predecessor, hiding it from shutdown's cancel rounds.
                self._cmd_seq += 1
                self.messenger.adopt_task(
                    f"{self.name}.election{self._cmd_seq}",
                    asyncio.get_event_loop().create_task(
                        self.start_election()),
                )
        elif t == "election_ack":
            if msg["epoch"] == self.election_epoch:
                self._election_acks.add(src_rank)
                if (
                    len(self._election_acks) >= self.majority
                    and self._election_done
                    and not self._election_done.done()
                ):
                    self._election_done.set_result(True)
        elif t == "election_victory":
            if msg["epoch"] >= self.election_epoch:
                self.election_epoch = msg["epoch"]
                self.leader = msg["leader"]
                self.quorum = msg["quorum"]

    # -- dispatch ----------------------------------------------------------

    async def dispatch(self, src: str, msg) -> None:
        if not isinstance(msg, dict):
            return
        t = msg.get("type", "")
        if t.startswith("election_"):
            await self._handle_election(src, msg)
        elif t == "paxos_collect":
            for rank, reply in self.paxos.handle_collect(
                int(src.split(".")[1]), msg
            ):
                await self._send_to_rank(rank, reply)
        elif t == "paxos_last":
            for rank, reply in self.paxos.handle_last(
                int(src.split(".")[1]), msg
            ):
                await self._send_to_rank(rank, reply)
        elif t == "paxos_begin":
            for rank, reply in self.paxos.handle_begin(
                int(src.split(".")[1]), msg
            ):
                await self._send_to_rank(rank, reply)
        elif t == "paxos_accept":
            self.paxos.handle_accept(int(src.split(".")[1]), msg)
        elif t == "paxos_commit":
            self.paxos.handle_commit(int(src.split(".")[1]), msg)
        elif t == "mon_lease_probe":
            if self.is_leader():
                await self.messenger.send_message(
                    self.name, src, {"type": "mon_lease"}
                )
        elif t == "mon_lease":
            if src == f"mon.{self.leader}":
                self._last_lease = asyncio.get_event_loop().time()
        elif t == "mon_subscribe":
            self._subscribers.add(src)
            await self.messenger.send_message(
                self.name,
                src,
                {"type": "osdmap", "map": self.osdmap.to_dict()},
            )
        elif t == "mon_command":
            # spawn: a proposal awaits peer accepts, which arrive through
            # this same dispatch loop — handling inline would deadlock.
            # adopt_task retains the task (collectable mid-flight
            # otherwise) and logs a handler crash.
            self._cmd_seq += 1
            self.messenger.adopt_task(
                f"{self.name}.cmd{self._cmd_seq}",
                asyncio.get_event_loop().create_task(
                    self._handle_command(src, msg)),
            )

    # -- committed-state application ---------------------------------------

    def _apply_commit(self, value: dict) -> str:
        """Apply one committed value; returns the slice name (also used
        for startup replay from the durable store, where nothing is
        pushed).  A value that carries a command's record key is applied
        once: the commit records the command's answer, and a later value
        with the same key (a resend that raced the first commit) applies
        as a no-op, slice ``"dup"``."""
        reqid = value.get("reqid")
        if reqid is None:
            return self._apply_inc(value["inc"])
        key = tuple(reqid)
        if key in self._reqid_results:
            return "dup"
        kind = self._apply_inc(value["inc"])
        self._reqid_results[key] = (0, self._answer(value["answer"]))
        while len(self._reqid_results) > REQIDS_TRACKED:
            self._reqid_results.popitem(last=False)
        return kind

    def _answer(self, spec) -> object:
        """A mutating command's answer, from its proposal's declarative
        form and this mon's state just after the commit: ``("epoch",)``,
        ``("mgrmap",)``, ``("fsmap",)`` or ``("const", out)``."""
        kind = spec[0]
        if kind == "epoch":
            return {"epoch": self.osdmap.epoch}
        if kind == "mgrmap":
            return self.mgrmap.to_dict()
        if kind == "fsmap":
            return self.fsmap.to_dict()
        return copy.deepcopy(spec[1])

    def _apply_inc(self, inc: dict) -> str:
        """Route one committed increment to its service slice; returns
        the slice name."""
        op = inc.get("op", "")
        if op.startswith("kv_"):
            self.kvstore.apply(inc)
            return "kv"
        if op.startswith("config_"):
            self.configdb.apply(inc)
            return "config"
        if op == "clog_append":
            self.clog.apply(inc)
            return "clog"
        if op.startswith("auth_"):
            # membership BEFORE apply: the keyring hook below must only
            # revoke AuthDB-managed entities, never file-provisioned
            # quorum/admin keys (mon.*, client) that share the ring
            was_managed = inc.get("entity") in self.authdb.entities
            self.authdb.apply(inc)
            # a mon running with cephx verifies CONNECTING peers against
            # its own keyring: keys minted/rotated through the AuthDB
            # must flow into it, or daemons provisioned via
            # `auth get-or-create` could never connect (the reference
            # mon validates against its auth database the same way)
            ring = getattr(self.messenger, "keyring", None)
            if ring is not None:
                ent = inc.get("entity")
                if op in ("auth_add", "auth_rotate") and ent is not None:
                    have = self.authdb.entities.get(ent)
                    if have is not None:
                        try:
                            ring.add(ent, bytes.fromhex(have["key"]))
                        except ValueError:
                            pass  # non-hex externally-set key: skip
                elif op == "auth_rm" and ent is not None and was_managed:
                    # revocation must bite: a removed entity can no
                    # longer complete the cephx handshake (store replay
                    # re-applies add THEN rm, converging removed)
                    ring.remove(ent)
            return "auth"
        if op.startswith("mgr_"):
            self.mgrmap.apply(inc)
            return "mgrmap"
        if op.startswith(("fs_", "mds_")):
            self.fsmap.apply(inc)
            return "fsmap"
        self.osdmap.apply(inc)
        return "osdmap"

    def _on_commit(self, v: int, value: dict) -> None:
        kind = self._apply_commit(value)
        if kind == "config":
            # runtime config distribution: every commit pushes the new
            # sections to subscribers (MonClient config notifications);
            # daemons pick their own entity_view out of it
            self._push_to_subscribers({
                "type": "config",
                "version": self.configdb.version,
                "sections": self.configdb.dump(),
            })
        elif kind == "osdmap":
            # every mon pushes to its own subscribers (clients subscribe
            # to all mons and dedup by epoch) — gating on is_leader()
            # here would drop broadcasts when leadership flickers
            # mid-commit during elections
            self._push_to_subscribers(
                {"type": "osdmap", "map": self.osdmap.to_dict()}
            )
        elif kind == "mgrmap":
            self._push_to_subscribers(
                {"type": "mgrmap", "map": self.mgrmap.to_dict()}
            )
        elif kind == "fsmap":
            self._push_to_subscribers(
                {"type": "fsmap", "map": self.fsmap.to_dict()}
            )

    def _push_to_subscribers(self, msg: dict) -> None:
        for sub in list(self._subscribers):
            # deep copy per subscriber: the in-process messenger passes
            # dicts by reference, and a receiver mutating its nested
            # map must not corrupt what the others see
            self._cmd_seq += 1
            self.messenger.adopt_task(
                f"{self.name}.push{self._cmd_seq}",
                asyncio.get_event_loop().create_task(
                    self.messenger.send_message(self.name, sub,
                                                copy.deepcopy(msg))),
            )

    # -- commands (OSDMonitor analogue) ------------------------------------

    async def _handle_command(self, src: str, msg: dict) -> None:
        cmd = msg["cmd"]
        # authenticated caller for cap checks and records: the wire
        # source, or the original requester when a peer mon forwarded.
        # A reply_to set by anything that is NOT a quorum peer is a spoof
        # attempt and is ignored for authorization purposes.
        caller = (msg.get("reply_to") if src.startswith("mon.")
                  else src) or src
        # a caller the command's cap check refuses gets no record key:
        # neither a recorded answer nor one read after do_command
        key = record_key(msg.get("reqid"), cmd, caller) \
            if self._may(cmd.get("prefix", ""), caller) else None
        done = self._reqid_results.get(key) if key is not None else None
        if done is not None:
            # a resend of a command this mon saw committed: the first
            # commit's answer, never a second application
            await self.messenger.send_message(
                self.name, msg.get("reply_to", src),
                {"type": "mon_command_reply", "id": msg["id"],
                 "rc": done[0], "out": done[1]})
            return
        if not self.is_leader():
            if self.leader is None:
                await self.messenger.send_message(
                    self.name,
                    src,
                    {
                        "type": "mon_command_reply",
                        "id": msg["id"],
                        "rc": -11,  # EAGAIN: no quorum
                        "out": "no leader",
                    },
                )
            else:
                # forward to the leader (Monitor.cc forward_request_leader)
                fwd = dict(msg)
                fwd["reply_to"] = src
                await self._send_to_rank(self.leader, fwd)
            return
        token = _RECORD_KEY.set(key)
        try:
            rc, out = await self.do_command(cmd, caller=caller)
        finally:
            _RECORD_KEY.reset(token)
        if key is not None and key in self._reqid_results:
            # the commit's answer: this execution's own (computed from the
            # state the commit left, as do_command's is), or the first
            # one's where a racing resend applied the command first
            rc, out = self._reqid_results[key]
        await self.messenger.send_message(
            self.name,
            msg.get("reply_to", src),
            {"type": "mon_command_reply", "id": msg["id"], "rc": rc, "out": out},
        )

    _pid_counter = 0

    async def _propose(self, inc: dict, answer=None) -> bool:
        """Commit ``inc`` through paxos.  ``answer`` (the command's
        declarative answer, see :meth:`_answer`) marks the final
        proposal of a mutating command: the value then carries the
        command's record key (see :func:`record_key`), when it has one,
        so that every mon records the answer and a resend applies
        nothing twice."""
        async with self._cmd_lock:  # one in-flight proposal (paxos updating)
            Monitor._pid_counter += 1
            value = {"inc": inc, "pid": f"{self.rank}:{Monitor._pid_counter}"}
            key = _RECORD_KEY.get() if answer is not None else None
            if key is not None:
                value["reqid"] = list(key)
                value["answer"] = list(answer)
            for _ in range(3):
                if await self.paxos.propose(value, self.quorum):
                    return True
                # stale pn (a competing election promised newer): recover
                if not await self.paxos.collect(self.quorum):
                    return False
                # recovery may have re-proposed and committed our value
                if any(
                    v.get("pid") == value["pid"]
                    for v in self.paxos.store.values.values()
                ):
                    return True
            return False

    async def _commit(self, inc: dict, answer) -> tuple:
        """Commit a mutating command's final increment; its ``(rc,
        out)``: ``answer`` (see :meth:`_answer`) read from the state the
        commit left, or -11 without a quorum."""
        if not await self._propose(inc, answer=answer):
            return -11, "no quorum"
        return 0, self._answer(answer)

    #: AuthMonitor mutations: minting, rotating, revoking or re-capping
    #: keys needs mon admin capability (reference: MonCap gates on
    #: 'allow *' / 'allow profile admin'; an osd.* service key minted via
    #: get-or-create must NOT be able to mint or revoke other keys)
    _AUTH_MUTATIONS = ("auth get-or-create", "auth rotate", "auth rm",
                      "auth caps")

    def _caller_admin_capable(self, caller: Optional[str]) -> bool:
        """Minimal mon-cap check mirroring the OSDCap enforcement model
        (osd/shard.py client_caps): entities with a registered
        AuthDB record are confined to their mon caps; unregistered
        entities (file-provisioned admin/bootstrap keys, open clusters
        without cephx) keep the open default; quorum peers and local
        (in-process, caller=None) invocations are trusted."""
        if caller is None:
            return True
        ent = caller.split("[")[0]
        if ent.startswith("mon."):
            return True
        rec = self.authdb.entities.get(ent)
        if rec is None:
            return True
        from ceph_tpu_torch.auth.caps import MonCap

        return MonCap.parse((rec.get("caps") or {}).get("mon", "")).is_admin()

    def _may(self, prefix: str, caller: Optional[str]) -> bool:
        """Whether ``caller`` passes the cap check of command ``prefix``."""
        return prefix not in self._AUTH_MUTATIONS or \
            self._caller_admin_capable(caller)

    async def do_command(self, cmd: dict, caller: Optional[str] = None):
        """Returns (rc, out).  Command names follow the ceph CLI.
        ``caller`` is the authenticated wire entity (None for local
        invocations); AuthMonitor mutations are gated on its mon caps."""
        prefix = cmd.get("prefix", "")
        if not self._may(prefix, caller):
            self.clog.apply({
                "op": "clog_append", "who": self.name, "level": "warn",
                "message": f"denied '{prefix}' from {caller}: no mon "
                           f"admin capability", "stamp": 0.0,
            })
            return -13, f"access denied: {caller} lacks mon admin caps"
        if prefix == "status":
            return 0, {
                "quorum": self.quorum,
                "leader": self.leader,
                "election_epoch": self.election_epoch,
                "osdmap_epoch": self.osdmap.epoch,
                "pools": sorted(self.osdmap.pools),
                "num_osds": self.osdmap.max_osd,
                "up_osds": sorted(
                    i for i, up in self.osdmap.up.items() if up
                ),
            }
        if prefix == "osd create":
            return await self._commit(
                {"op": "create_osds", "n": cmd["n"]},
                ("const", f"created {cmd['n']} osds"))
        if prefix == "osd boot":
            # an OSD daemon reporting for duty (reference OSD::_send_boot
            # -> OSDMonitor::prepare_boot, src/osd/OSD.cc:5386): mark it
            # up, clear pending failure reports against it, bump the
            # epoch so subscribers re-peer onto it
            osd = int(cmd["osd"])
            if osd >= self.osdmap.max_osd:
                ok = await self._propose({"op": "create_osds", "n": osd + 1})
                if not ok:
                    return -11, "no quorum"
            self._failure_reports.pop(osd, None)
            if self.osdmap.up.get(osd):
                return 0, {"epoch": self.osdmap.epoch, "already_up": True}
            return await self._commit({"op": "osd_up", "osd": osd},
                                      ("epoch",))
        if prefix == "osd failure":
            # peer-reported failure (reference MOSDFailure ->
            # OSDMonitor::check_failure, src/mon/OSDMonitor.cc): collect
            # DISTINCT reporters; at mon_osd_min_down_reporters the
            # target is marked down and the epoch bump broadcasts.
            # Report state is leader-local, like the reference's pending
            # failure_info_t (not paxos state).
            from ceph_tpu_torch.utils.config import get_config

            osd = int(cmd["osd"])
            if not self.osdmap.up.get(osd):
                return 0, {"already_down": True}
            now = asyncio.get_event_loop().time()
            reporters = self._failure_reports.setdefault(osd, {})
            reporters[cmd.get("from", "?")] = now
            # expire reports older than ~4 heartbeat-grace windows: a
            # genuinely-down OSD is re-reported every grace interval, so
            # live reports refresh; stale ones age out (reference
            # OSDMonitor expires failure_info_t / handles cancellations)
            expiry = 4 * float(get_config().get_val("osd_heartbeat_grace"))
            for rep, stamp in list(reporters.items()):
                if now - stamp > expiry:
                    del reporters[rep]
            need = int(get_config().get_val("mon_osd_min_down_reporters"))
            if len(reporters) < need:
                return 0, {"reports": len(reporters), "need": need}
            self._failure_reports.pop(osd, None)
            rc, out = await self._commit({"op": "osd_down", "osd": osd},
                                         ("const", {"marked_down": True}))
            if rc == 0:
                self.clog.apply({
                    "op": "clog_append", "who": self.name,
                    "level": "warn",
                    "message": f"osd.{osd} failed "
                               f"({len(reporters)} reporters)",
                    "stamp": 0.0,
                })
            return rc, out
        if prefix == "osd erasure-code-profile set":
            name, profile = cmd["name"], dict(cmd["profile"])
            # validate by instantiating the codec (OSDMonitor.cc:5353)
            from ceph_tpu_torch.osd.cluster import DEFAULT_PLUGIN
            from ceph_tpu_torch.plugins import registry as registry_mod

            plugin = profile.get("plugin", DEFAULT_PLUGIN)
            try:
                registry_mod.instance().factory(
                    plugin, {k: v for k, v in profile.items() if k != "plugin"}
                )
            except Exception as e:  # noqa: BLE001 -- validation surface
                return -22, f"invalid profile: {e}"
            return await self._commit(
                {"op": "profile_set", "name": name, "profile": profile},
                ("const", name))
        if prefix == "osd erasure-code-profile ls":
            return 0, sorted(self.osdmap.ec_profiles)
        if prefix == "osd erasure-code-profile get":
            p = self.osdmap.ec_profiles.get(cmd["name"])
            return (0, p) if p is not None else (-2, "not found")
        if prefix == "osd erasure-code-profile rm":
            for pool in self.osdmap.pools.values():
                if pool.profile_name == cmd["name"]:
                    return -16, f"profile in use by pool {pool.name}"  # EBUSY
            return await self._commit(
                {"op": "profile_rm", "name": cmd["name"]}, ("const", ""))
        if prefix == "osd pool create":
            name = cmd["name"]
            if name in self.osdmap.pools:
                return -17, "pool exists"  # EEXIST
            if cmd.get("pool_type") == "replicated":
                # TYPE_REPLICATED arm (reference OSDMonitor::prepare_new_pool,
                # src/mon/OSDMonitor.cc:5529; pg_pool_t size/min_size)
                size = int(cmd.get("size", 3))
                if size < 1 or (
                    self.osdmap.max_osd and size > self.osdmap.max_osd
                ):
                    return -22, f"bad replicated size {size}"
                min_size = int(
                    cmd.get("min_size", max(1, size - size // 2)))
                if not 1 <= min_size <= size:
                    # reference OSDMonitor rejects min_size outside
                    # [1, size] (a pool that could never accept a write)
                    return -22, f"bad min_size {min_size} (size {size})"
                pool = {
                    "name": name,
                    "pool_type": "replicated",
                    "size": size,
                    "min_size": min_size,
                    "pg_num": cmd.get("pg_num", 128),
                    "hosts": cmd.get("hosts"),
                }
                return await self._commit({"op": "pool_create", "pool": pool},
                                          ("const", pool))
            pname = cmd["profile"]
            profile = self.osdmap.ec_profiles.get(pname)
            if profile is None:
                return -2, f"no profile {pname}"
            from ceph_tpu_torch.osd.cluster import DEFAULT_PLUGIN
            from ceph_tpu_torch.plugins import registry as registry_mod

            plugin = profile.get("plugin", DEFAULT_PLUGIN)
            ec = registry_mod.instance().factory(
                plugin, {k: v for k, v in profile.items() if k != "plugin"}
            )
            ec_k = ec.get_data_chunk_count()
            ec_m = ec.get_chunk_count() - ec_k
            # EC min_size default k + min(1, m-1) (reference
            # OSDMonitor::prepare_new_pool pg_pool_t): a write accepted
            # with exactly k shards up has zero redundancy
            min_size = int(cmd.get(
                "min_size", ec_k + min(1, max(0, ec_m - 1))))
            if not ec_k <= min_size <= ec_k + ec_m:
                return -22, f"bad min_size {min_size} (k={ec_k} m={ec_m})"
            pool = {
                "name": name,
                "pool_type": "erasure",
                "profile_name": pname,
                "k": ec_k,
                "m": ec_m,
                "min_size": min_size,
                "pg_num": cmd.get("pg_num", 128),
                "hosts": cmd.get("hosts"),
            }
            return await self._commit({"op": "pool_create", "pool": pool},
                                      ("const", pool))
        # -- cache tiering (OSDMonitor `osd tier` subset re-targeted at
        # device residency: the cache device is the card's memory, so the
        # commands set the pool's mode rather than overlay a second
        # pool) --------------------------------------------------------
        if prefix == "osd tier cache-mode":
            from ceph_tpu_torch.tier import CACHE_MODES

            name, mode = cmd["pool"], cmd["mode"]
            if name not in self.osdmap.pools:
                return -2, f"no pool {name}"
            if mode not in CACHE_MODES:
                return -22, (f"bad cache mode {mode!r} (want one of "
                             f"{'/'.join(CACHE_MODES)})")
            return await self._commit(
                {"op": "pool_tier", "name": name, "cache_mode": mode},
                ("const", {"pool": name, "cache_mode": mode}))
        if prefix == "osd tier status":
            from ceph_tpu_torch.utils.config import get_config as _gc

            return 0, {
                "hbm_budget_bytes": int(_gc().get_val(
                    "osd_tier_hbm_bytes")),
                "pools": {
                    name: {"cache_mode": p.cache_mode}
                    for name, p in sorted(self.osdmap.pools.items())
                },
            }
        # -- ConfigKeyService (src/mon/ConfigKeyService.cc) ----------------
        if prefix == "config-key set":
            return await self._commit(
                {"op": "kv_set", "key": cmd["key"], "value": cmd["value"]},
                ("const", ""))
        if prefix == "config-key get":
            v = self.kvstore.kv.get(cmd["key"])
            return (0, v) if v is not None else (-2, "not found")
        if prefix == "config-key rm":
            return await self._commit({"op": "kv_rm", "key": cmd["key"]},
                                      ("const", ""))
        if prefix == "config-key ls":
            return 0, sorted(self.kvstore.kv)
        if prefix == "config-key exists":
            return (0, "") if cmd["key"] in self.kvstore.kv \
                else (-2, "not found")
        # -- centralized config (ConfigMonitor role) -----------------------
        if prefix == "config set":
            return await self._commit({
                "op": "config_set", "who": cmd["who"],
                "name": cmd["name"], "value": str(cmd["value"]),
            }, ("const", ""))
        if prefix == "config rm":
            return await self._commit({
                "op": "config_rm", "who": cmd["who"], "name": cmd["name"]},
                ("const", ""))
        if prefix == "config get":
            return 0, self.configdb.entity_view(cmd["who"])
        if prefix == "config dump":
            return 0, self.configdb.dump()
        # -- cluster log (LogMonitor) --------------------------------------
        if prefix == "log":
            level = cmd.get("level", "info")
            if level not in ClusterLog.LEVELS:
                return -22, f"bad level {level!r} (want one of " \
                            f"{'/'.join(ClusterLog.LEVELS)})"
            return await self._commit({
                "op": "clog_append", "who": cmd.get("who", "client"),
                "level": level,
                "message": cmd.get("message", ""),
                "stamp": cmd.get("stamp", 0.0),
            }, ("const", "logged"))
        if prefix == "log last":
            level = cmd.get("level")
            if level is not None and level not in ClusterLog.LEVELS:
                return -22, f"bad level {level!r}"
            return 0, self.clog.last(cmd.get("num", 20), level)
        # -- AuthMonitor (src/mon/AuthMonitor.cc subset) -------------------
        if prefix == "auth get-or-create":
            ent = cmd["entity"]
            have = self.authdb.entities.get(ent)
            if have is not None:
                return 0, {"entity": ent, "key": have["key"],
                           "caps": dict(have["caps"])}
            import secrets as _secrets

            key = _secrets.token_hex(16)
            return await self._commit({
                "op": "auth_add", "entity": ent, "key": key,
                "caps": cmd.get("caps") or {},
            }, ("const", {"entity": ent, "key": key,
                         "caps": dict(cmd.get("caps") or {})}))
        if prefix == "auth get":
            have = self.authdb.entities.get(cmd["entity"])
            if have is None:
                return -2, "not found"
            return 0, {"entity": cmd["entity"], "key": have["key"],
                       "caps": dict(have["caps"])}
        if prefix == "auth caps":
            if cmd["entity"] not in self.authdb.entities:
                return -2, "not found"
            return await self._commit({
                "op": "auth_caps", "entity": cmd["entity"],
                "caps": cmd.get("caps") or {},
            }, ("const", ""))
        if prefix == "auth rotate":
            # key rotation (the reference's rotating secrets role): a
            # fresh secret replaces the old; clients re-key on their
            # next handshake
            if cmd["entity"] not in self.authdb.entities:
                return -2, "not found"
            import secrets as _secrets

            key = _secrets.token_hex(16)
            return await self._commit({
                "op": "auth_rotate", "entity": cmd["entity"], "key": key},
                ("const", {"key": key}))
        if prefix == "auth rm":
            if cmd["entity"] not in self.authdb.entities:
                return -2, "not found"  # never strips file-provisioned keys
            return await self._commit(
                {"op": "auth_rm", "entity": cmd["entity"]}, ("const", ""))
        if prefix == "auth list":
            return 0, {
                e: {"caps": dict(v["caps"])}  # keys never leave via list
                for e, v in sorted(self.authdb.entities.items())
            }
        # -- MgrMonitor (src/mon/MgrMonitor.cc subset) ---------------------
        if prefix == "mgr beacon":
            name = cmd["name"]
            now = asyncio.get_event_loop().time()
            self._beacons[f"mgr.{name}"] = now
            known = (name == self.mgrmap.active
                     or name in self.mgrmap.standbys)
            if not known:
                ok = await self._propose({"op": "mgr_register",
                                          "name": name})
                if not ok:
                    return -11, "no quorum"
            # a standby's beacon checks the active's liveness (lazy
            # failover; the reference's beacon grace)
            active = self.mgrmap.active
            if active is not None and active != name:
                last = self._beacons.get(f"mgr.{active}")
                from ceph_tpu_torch.utils.config import get_config as _gc

                grace = float(_gc().get_val("mon_mgr_beacon_grace"))
                if last is not None and now - last > grace:
                    await self._propose({"op": "mgr_failover",
                                         "failed": active})
            return 0, self.mgrmap.to_dict()
        if prefix == "mgr fail":
            who = cmd.get("who", self.mgrmap.active)
            if who is None:
                return -2, "no active mgr"
            return await self._commit({"op": "mgr_failover", "failed": who},
                                      ("mgrmap",))
        if prefix == "mgr stat":
            return 0, self.mgrmap.to_dict()
        # -- MDSMonitor (src/mon/MDSMonitor.cc subset) ---------------------
        if prefix == "fs new":
            if cmd["name"] in self.fsmap.filesystems:
                return -17, "fs exists"
            return await self._commit({
                "op": "fs_new", "name": cmd["name"],
                "max_mds": cmd.get("max_mds", 1),
            }, ("fsmap",))
        if prefix == "fs rm":
            if cmd["name"] not in self.fsmap.filesystems:
                return -2, "no such fs"
            return await self._commit({"op": "fs_rm", "name": cmd["name"]},
                                      ("const", ""))
        if prefix == "fs set max_mds":
            if cmd["name"] not in self.fsmap.filesystems:
                return -2, "no such fs"
            return await self._commit({
                "op": "fs_set_max_mds", "name": cmd["name"],
                "max_mds": int(cmd["max_mds"]),
            }, ("fsmap",))
        if prefix == "fs ls":
            return 0, sorted(self.fsmap.filesystems)
        if prefix == "mds beacon":
            name = cmd["name"]
            self._beacons[f"mds.{name}"] = asyncio.get_event_loop().time()
            known = (name in self.fsmap.standbys or any(
                name in fs["ranks"].values()
                for fs in self.fsmap.filesystems.values()
            ))
            if not known:
                ok = await self._propose({"op": "mds_register",
                                          "name": name})
                if not ok:
                    return -11, "no quorum"
            return 0, self.fsmap.to_dict()
        if prefix == "mds fail":
            return await self._commit({"op": "mds_failover",
                                       "name": cmd["name"]}, ("fsmap",))
        if prefix == "fs dump":
            return 0, self.fsmap.to_dict()
        if prefix == "osd add":
            # elastic expansion (reference `osd new`, OSDMonitor.cc
            # prepare_command_osd_new): one new id enters the map up+in;
            # the epoch bump broadcasts and subscribers grow their
            # placements through apply_map_view
            osd = int(cmd["osd"])
            if osd in self.osdmap.up:
                return -17, f"osd.{osd} already exists"  # EEXIST
            inc = {"op": "osd_add", "osd": osd}
            if "weight" in cmd:
                from ceph_tpu_torch.crush.map import weight_fp

                inc["weight"] = weight_fp(cmd["weight"])  # float -> 16.16
            return await self._commit(inc, ("epoch",))
        if prefix == "osd rm":
            # elastic contraction; refuse to drop any pool below its
            # mappable floor (registry-validation parity: same EBUSY
            # shape as profile-in-use)
            osd = int(cmd["osd"])
            if osd not in self.osdmap.up:
                return -2, f"osd.{osd} does not exist"  # ENOENT
            blocked = self._min_size_block(osd)
            if blocked:
                return -16, blocked  # EBUSY
            return await self._commit({"op": "osd_rm", "osd": osd},
                                      ("epoch",))
        if prefix in ("osd out", "osd in", "osd down", "osd up"):
            if prefix == "osd out":
                blocked = self._min_size_block(int(cmd["osd"]))
                if blocked:
                    return -16, blocked  # EBUSY
            inc = {"op": f"osd_{prefix.split()[1]}", "osd": cmd["osd"]}
            if prefix == "osd in" and "weight" in cmd:
                from ceph_tpu_torch.crush.map import weight_fp

                inc["weight"] = weight_fp(cmd["weight"])  # float -> 16.16
            return await self._commit(inc, ("const", ""))
        return -38, f"unknown command {prefix}"  # ENOSYS

    def _min_size_block(self, victim: int) -> Optional[str]:
        """Would taking ``victim`` out of the data plane drop any pool's
        mappable positions below min_size?  Returns the refusal message
        (EBUSY text) or None when safe."""
        survivors = sum(
            1 for o, w in self.osdmap.weights.items()
            if w > 0 and o != victim
        )
        for pool in self.osdmap.pools.values():
            need = pool.min_size or (pool.k + pool.m if pool.k else pool.size)
            if survivors < need:
                return (
                    f"removing osd.{victim} would leave {survivors} "
                    f"mappable osds < min_size {need} for pool {pool.name}"
                )
        return None


class MonClient:
    """Client-side handle: send commands to any live monitor, subscribe to
    map updates (reference: src/mon/MonClient.cc hunting + subscriptions)."""

    def __init__(self, messenger: Messenger, n_mons: int, name: str):
        self.messenger = messenger
        self.n_mons = n_mons
        self.name = name
        #: reqid incarnation: (name, incarnation, tid) names each command
        #: across its resends, and no other instance's
        self.incarnation = next(_INCARNATIONS)
        self._id = 0
        self._replies: Dict[int, asyncio.Future] = {}
        self._active = 0  # last monitor that answered (hunting state)

    async def handle_reply(self, msg: dict) -> bool:
        """Feed mon_command_reply dicts here from the owner's dispatcher."""
        if msg.get("type") != "mon_command_reply":
            return False
        fut = self._replies.pop(msg["id"], None)
        if fut and not fut.done():
            fut.set_result((msg["rc"], msg["out"]))
        return True

    async def command(self, cmd: dict, timeout: float = 2.0):
        """Try each monitor until one answers (hunting).  The command
        keeps one request id, ``(name, incarnation, tid)``, across every
        resend, so a mon that already committed it answers the first
        commit's result, and a late reply to an earlier send is taken as
        the answer."""
        last = (-110, "timeout")  # ETIMEDOUT
        self._id += 1
        mid = self._id
        reqid = [self.name, self.incarnation, mid]
        loop = asyncio.get_event_loop()
        fut = self._replies[mid] = loop.create_future()
        try:
            for attempt in range(self.n_mons):
                rank = (self._active + attempt) % self.n_mons
                if self.messenger.is_down(f"mon.{rank}"):
                    continue  # don't burn a timeout on a known-dead mon
                await self.messenger.send_message(
                    self.name,
                    f"mon.{rank}",
                    {"type": "mon_command", "cmd": cmd, "id": mid,
                     "reqid": reqid},
                )
                done, _ = await asyncio.wait({fut}, timeout=timeout)
                if not done:
                    continue
                rc, out = fut.result()
                if rc == -11:  # EAGAIN: that mon has no leader yet
                    last = (rc, out)
                    fut = self._replies[mid] = loop.create_future()
                    continue
                # affinity hint only: concurrent command() calls may each
                # stick a different answering mon and ANY of them is a
                # valid next-attempt start -- no invariant to clobber
                self._active = rank  # cephlint: disable=async-rmw-across-await
                return rc, out
            return last
        finally:
            self._replies.pop(mid, None)

    async def subscribe(self) -> None:
        for r in range(self.n_mons):
            await self.messenger.send_message(
                self.name, f"mon.{r}", {"type": "mon_subscribe"}
            )


class MonCluster:
    """n monitors on one messenger (the mon side of a vstart cluster)."""

    def __init__(self, n_mons: int, messenger: Messenger, tick: bool = True,
                 store_dir: Optional[str] = None):
        self.messenger = messenger
        self.mons = [
            Monitor(r, n_mons, messenger,
                    store_path=(f"{store_dir}/mon.{r}" if store_dir
                                else None))
            for r in range(n_mons)
        ]
        self._tick = tick

    async def form_quorum(self, timeout: float = 3.0) -> Monitor:
        """Kick an election from the lowest live rank and wait for quorum."""
        for mon in self.mons:
            if not self.messenger.is_down(mon.name):
                mon._cmd_seq += 1
                self.messenger.adopt_task(
                    f"{mon.name}.election{mon._cmd_seq}",
                    asyncio.get_event_loop().create_task(
                        mon.start_election()),
                )
                break
        leader = await self.wait_for_leader(timeout)
        if self._tick:
            for mon in self.mons:
                if f"{mon.name}.tick" not in self.messenger._tasks:
                    mon.start_tick()
        return leader

    async def wait_for_leader(self, timeout: float = 3.0) -> Monitor:
        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            for mon in self.mons:
                if mon.is_leader() and not self.messenger.is_down(mon.name):
                    return mon
            await asyncio.sleep(0.02)
        raise TimeoutError("no monitor quorum")

    def kill(self, rank: int) -> None:
        self.messenger.mark_down(f"mon.{rank}")

    def revive(self, rank: int) -> None:
        self.messenger.mark_up(f"mon.{rank}")

    def close_stores(self) -> None:
        for mon in self.mons:
            mon.close_store()
