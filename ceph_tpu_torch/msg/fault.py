"""Messenger fault injection (ms_inject_* analogue).

Port of ``ceph_tpu/msg/fault.py``.  The reference also reports each
injected tear to its runtime atomic-section verifier; the port has no
such verifier, so tears are only counted.

Reference: the ms_inject_socket_failures / ms_inject_delay knobs in
src/common/options.cc:735-756 drive the messenger layer directly.  This
module lives in ``ceph_tpu_torch.msg`` because the TRANSPORT owns failure
injection; the OSD layer's messenger re-exports it.

Besides per-message drop/delay, the injector can kill a CONNECTION
mid-burst (``schedule_conn_kill``): the corked send path asks
``conn_kill_split`` how many frames of the next burst may be written
before the transport must be torn down, which is how the lossless-replay
tests manufacture a torn burst deterministically.
"""

from __future__ import annotations

import asyncio
import random
from typing import Dict, Optional, Tuple


class FaultInjector:
    """ms_inject_* analogue; probabilities in [0, 1]."""

    def __init__(self, drop_probability: float = 0.0,
                 delay_probability: float = 0.0,
                 max_delay: float = 0.0, seed: int = 0):
        self.drop_probability = drop_probability
        self.delay_probability = delay_probability
        self.max_delay = max_delay
        self._rng = random.Random(seed)
        self.dropped = 0
        #: one-shot connection kill: abort the wire after this many more
        #: frames have been written (None = disarmed)
        self._conn_kill_countdown: Optional[int] = None
        self.conn_kills = 0
        #: one-shot primary kill in the dup-detection window: the OSD
        #: daemon consults this after a client op APPLIES but before the
        #: reply frame is sent (None = disarmed, "*" = any op kind)
        self._kill_after_apply: Optional[str] = None
        self.apply_kills = 0
        #: one-shot shared-memory ring tear: the Nth next ring record
        #: push publishes a TORN record (header out, body half-written
        #: -- the producer "died" mid-publish) and the producer writes
        #: nothing further (None = disarmed)
        self._ring_tear_countdown: Optional[int] = None
        self.ring_tears = 0
        #: one-shot per-sender holds: sender entity -> (seconds, message
        #: type or None); the port's addition, which the mon tests use to
        #: make one mon's reply arrive after the client's wait
        self._send_holds: Dict[str, Tuple[float, Optional[str]]] = {}
        self.send_holds = 0

    @classmethod
    def from_config(cls) -> "FaultInjector":
        """Build from the ms_inject_* options AND track runtime changes
        through a config observer (reference: the injection knobs in
        src/common/options.cc drive the messenger directly and respond
        to injectargs; qa suites just set the config, before OR after
        the daemons boot)."""
        import weakref

        from ceph_tpu_torch.utils.config import get_config

        cfg = get_config()
        inj = cls()

        def _sync(target):
            n = int(cfg.get_val("ms_inject_socket_failures") or 0)
            delay_p = float(cfg.get_val("ms_inject_internal_delays")
                            or 0.0)
            target.drop_probability = (1.0 / n) if n > 0 else 0.0
            target.delay_probability = delay_p
            target.max_delay = 0.05 if delay_p else 0.0

        _sync(inj)
        # the observer must not keep the injector (and its messenger)
        # alive forever: hold it weakly and self-remove once the owner
        # is gone, or a harness that churns clusters would grow the
        # global observer list without bound
        ref = weakref.ref(inj)

        def _obs(changed):
            target = ref()
            if target is None:
                try:
                    cfg._observers.remove(_obs)
                except ValueError:
                    pass
                return
            if changed & {"ms_inject_socket_failures",
                          "ms_inject_internal_delays"}:
                _sync(target)

        cfg.add_observer(_obs)
        return inj

    def maybe_drop(self) -> bool:
        if self.drop_probability and \
                self._rng.random() < self.drop_probability:
            self.dropped += 1
            return True
        return False

    async def maybe_delay(self) -> None:
        if self.delay_probability and \
                self._rng.random() < self.delay_probability:
            await asyncio.sleep(self._rng.random() * self.max_delay)

    def schedule_send_hold(self, src: str, seconds: float,
                           kind: Optional[str] = None) -> None:
        """Arm a one-shot hold: the next message ``src`` sends (of dict
        ``type`` ``kind``, or any message when None) waits ``seconds``
        before the messenger delivers it."""
        self._send_holds[src] = (float(seconds), kind)

    def send_hold(self, src: str, msg: object) -> float:
        """Seconds to hold the message ``src`` is sending: the armed
        hold when it matches (firing disarms), else 0."""
        armed = self._send_holds.get(src)
        if armed is None:
            return 0.0
        seconds, kind = armed
        if kind is not None and not (
                isinstance(msg, dict) and msg.get("type") == kind):
            return 0.0
        del self._send_holds[src]
        self.send_holds += 1
        return seconds

    # -- apply/reply-window injection (dup-detection manufacture) ----------

    def schedule_kill_after_apply(self, kind: Optional[str] = None) -> None:
        """Arm a one-shot primary kill in the exactly-once window: the
        next client op (of ``kind``, or any kind when None) executes and
        APPLIES fully, then its primary OSD is marked down BEFORE the
        reply frame goes out -- the deterministic reproducer for reqid
        dup detection (the client must resend and receive the ORIGINAL
        result from the PG log, never a second application)."""
        self._kill_after_apply = kind if kind is not None else "*"

    def kill_after_apply_fire(self, kind: str) -> bool:
        """Consulted by the OSD between apply and reply; True exactly
        once when armed for ``kind`` (firing disarms)."""
        armed = self._kill_after_apply
        if armed is None or (armed != "*" and armed != kind):
            return False
        self._kill_after_apply = None
        self.apply_kills += 1
        return True

    # -- ring-level injection (torn-record manufacture) --------------------

    def schedule_ring_tear(self, after_records: int = 0) -> None:
        """Arm a one-shot shared-memory ring tear: after ``after_records``
        more ring records publish cleanly, the NEXT record goes out torn
        (length header published, body incomplete -- a producer crash
        mid-``memcpy``) and the producing side writes nothing further.
        The consumer's record crc turns the torn record into a
        ``RingTear`` (a ConnectionResetError), driving the messenger's
        ordinary drop + reconnect + session-replay path."""
        self._ring_tear_countdown = max(0, after_records)

    def ring_tear_fire(self) -> bool:
        """Consulted by the ring writer before each record push; True
        exactly once when the armed countdown reaches the record about
        to be pushed (firing disarms)."""
        if self._ring_tear_countdown is None:
            return False
        if self._ring_tear_countdown > 0:
            self._ring_tear_countdown -= 1
            return False
        self._ring_tear_countdown = None
        self.ring_tears += 1
        return True

    # -- connection-level injection (torn-burst manufacture) ---------------

    def schedule_conn_kill(self, after_frames: int) -> None:
        """Arm a one-shot kill: the connection carrying the Nth next
        frame is aborted BEFORE that frame is written (a burst is torn
        mid-flight, the replay tests' worst case)."""
        self._conn_kill_countdown = max(0, after_frames)

    def conn_kill_split(self, nframes: int) -> int:
        """How many of the next ``nframes`` frames may be written before
        an armed kill fires; -1 when no kill is due within the burst.
        Firing disarms the injector (one-shot) and counts the kill."""
        if self._conn_kill_countdown is None:
            return -1
        if self._conn_kill_countdown >= nframes:
            self._conn_kill_countdown -= nframes
            return -1
        split = self._conn_kill_countdown
        self._conn_kill_countdown = None
        self.conn_kills += 1
        return split
