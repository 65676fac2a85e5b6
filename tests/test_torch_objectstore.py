"""The port's persistent object stores (``objectstore/{filestore,kstore,
blockstore,statfs}.py``), their KV layer (``kv/``), the encoding framework
(``utils/encoding.py``), ``compressor.py`` and ``utils/log.py`` against the
JAX package's.

Every case runs the same transactions through both packages, each in a
directory of its own, and compares what they return and what they leave on
disk.  These are stored bytes, so every comparison is exact: the same file
names with the same bytes, for filestore, kstore, blockstore and
``blockstore:zlib``.  Each package mounts and reads the stores the other
wrote, both packages call ``os.fsync`` the same number of times for the
same transactions, and an EC cluster on each engine (the port's ``cuda``
plugin with profile ``device=cpu``, the JAX package's ``jerasure``) leaves
every OSD's objects, xattrs and omap identical.  Payloads are made with
numpy from a seed.
"""

import asyncio
import os
import types
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu import compressor as j_compressor
from ceph_tpu import kv as j_kv
from ceph_tpu import objectstore as j_objectstore
from ceph_tpu.kv import keyvaluedb as j_keyvaluedb
from ceph_tpu.objectstore import filestore as j_filestore
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.osd import types as j_types
from ceph_tpu.utils import encoding as j_encoding
from ceph_tpu_torch import compressor, kv, objectstore
from ceph_tpu_torch.kv import keyvaluedb
from ceph_tpu_torch.objectstore import filestore
from ceph_tpu_torch.osd import cluster, cluster_bench, durable_bench, ecutil
from ceph_tpu_torch.osd import types as t_types
from ceph_tpu_torch.plugins import registry
from ceph_tpu_torch.utils import config, encoding, log

KINDS = ["memstore", "filestore", "kstore", "blockstore", "blockstore:zlib"]
PERSISTENT = ["filestore", "kstore", "blockstore", "blockstore:zlib"]

PORT = types.SimpleNamespace(
    name="port", os_mod=objectstore, Transaction=t_types.Transaction,
    kv=kv, KVTransaction=keyvaluedb.KVTransaction, enc=encoding,
    encode_txn=filestore._encode_txn, compressor=compressor,
    make=lambda n, prof, **kw: cluster.ECCluster(
        n, dict(prof, device="cpu"), plugin="cuda", **kw),
    with_mons=lambda n, prof, **kw: cluster.ECCluster.create_with_mons(
        n, dict(prof, device="cpu"), plugin="cuda", **kw))
JAX = types.SimpleNamespace(
    name="jax", os_mod=j_objectstore, Transaction=j_types.Transaction,
    kv=j_kv, KVTransaction=j_keyvaluedb.KVTransaction, enc=j_encoding,
    encode_txn=j_filestore._encode_txn, compressor=j_compressor,
    make=lambda n, prof, **kw: j_cluster.ECCluster(
        n, dict(prof), plugin="jerasure", **kw),
    with_mons=lambda n, prof, **kw: j_cluster.ECCluster.create_with_mons(
        n, dict(prof), plugin="jerasure", **kw))
BOTH = (PORT, JAX)

#: what a crash mid-append leaves at a log's end
GARBAGE = b"torn-garbage-record"


def _policy_runs_tasks() -> bool:
    """Whether the current event-loop policy's loops can run a task (the
    tier-1 conftest's atomic-section verifier cannot under Python 3.12)."""
    async def nothing():
        return None

    coro = nothing()
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(coro)
        return True
    except TypeError:
        coro.close()
        return False
    finally:
        loop.close()


@pytest.fixture(autouse=True)
def _loop_policy():
    """Keep the conftest's verifying policy where it can run a task; where
    it cannot, this file's loops, the JAX package's included, run under
    asyncio's default policy."""
    if _policy_runs_tasks():
        yield
        return
    saved = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(asyncio.DefaultEventLoopPolicy())
    yield
    asyncio.set_event_loop_policy(saved)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _bytes(seed, n):
    return np.random.RandomState(seed).randint(
        0, 256, size=n, dtype=np.uint8).tobytes()


def tree(path) -> dict:
    """Relative file name -> bytes of every file under ``path``."""
    root = Path(path)
    if not root.exists():
        return {}
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def xattrs(store, oid) -> dict:
    """Every xattr of ``oid``, through each engine's own metadata."""
    kind = type(store).__name__
    if kind == "MemStore":
        return dict(store._objects[oid].xattrs)
    if kind == "FileStore":
        return store._read_attrs(oid)
    if kind == "KStore":
        return dict(store._get_meta(oid)["xattrs"])
    return dict(store._get_onode(oid)["attrs"])


def snapshot(store) -> dict:
    """oid -> (data, xattrs, omap) over a store's public surface."""
    return {oid: (store.read(oid), xattrs(store, oid), store.omap_get(oid))
            for oid in store.list_objects()}


def _try(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 -- the outcome is compared
        return ("raises", type(exc).__name__)


# -- encoding framework --------------------------------------------------

VALUES = [
    None, True, False, 0, 1, -5, 2**40, b"", b"bytes", "stré", 1.5,
    [1, "two", b"3"], (1, (2, "x")), {"a": 1, "b": [None, {"c": b"x"}]},
    np.int64(7), bytearray(b"ba"), memoryview(b"mv"),
]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_encoding_roundtrip_matches_jax(i):
    v = VALUES[i]
    mine = encoding.Encoder().value(v)
    theirs = j_encoding.Encoder().value(v)
    assert mine.bytes() == theirs.bytes()
    assert mine.nbytes() == len(mine.bytes())
    assert encoding.Decoder(mine.bytes()).value() == \
        j_encoding.Decoder(theirs.bytes()).value()
    if not isinstance(v, (np.integer, bytearray, memoryview)):
        assert encoding.Decoder(mine.bytes()).value() == v


def test_encoding_frame_detects_corruption():
    payload = encoding.Encoder().string("hello").bytes()
    rec = encoding.frame(payload)
    assert rec == j_encoding.frame(payload)
    out, pos = encoding.unframe(rec, 0)
    assert out == payload and pos == len(rec)
    # flip a payload byte -> crc mismatch -> treated as torn
    bad = bytearray(rec)
    bad[-1] ^= 0xFF
    out, pos = encoding.unframe(bytes(bad), 0)
    assert out is None and pos == 0
    # short record, bad magic
    assert encoding.unframe(rec[:len(rec) - 1], 0) == (None, 0)
    assert encoding.unframe(b"\0" * 12 + payload, 0) == (None, 0)


def test_encoding_parts_and_crc_match_jax():
    big = _bytes(1, 9000)
    parts = [encoding.Encoder().u8(3).u32(7).u64(2**40).varint(300)
             .blob(big).blob_ref(bytearray(b"ref")).string("s")
             .blob_parts([b"ab", b"cd"]).parts(),
             j_encoding.Encoder().u8(3).u32(7).u64(2**40).varint(300)
             .blob(big).blob_ref(bytearray(b"ref")).string("s")
             .blob_parts([b"ab", b"cd"]).parts()]
    assert [bytes(p) for p in parts[0]] == [bytes(p) for p in parts[1]]
    assert len(parts[0]) == 3  # header run, the big blob, the tail run
    assert encoding.crc32c_parts(parts[0]) == \
        j_encoding.crc32c_parts(parts[1])
    assert encoding.crc32c_parts([]) == j_encoding.crc32c_parts([])
    assert b"".join(bytes(p) for p in encoding.frame_parts(parts[0])) == \
        j_encoding.frame(b"".join(bytes(p) for p in parts[1]))
    dec = encoding.Decoder(b"".join(bytes(p) for p in parts[0]))
    assert (dec.u8(), dec.u32(), dec.u64(), dec.varint()) == \
        (3, 7, 2**40, 300)
    assert dec.blob() == big and dec.blob() == b"ref"
    with pytest.raises(ValueError):
        encoding.Decoder(b"\x63").value()  # no such tag
    with pytest.raises(TypeError):
        encoding.Encoder().value({1: 2})


# -- compressor and log ----------------------------------------------------


@pytest.mark.parametrize("alg", ["zlib", "bz2", "lzma", "none", "snappy",
                                 "zstd", "lz4", "brotli", "rot13"])
def test_compressor_matches_jax(alg):
    data = b"compress me " * 500 + _bytes(2, 300)
    mine = _try(lambda: compressor.create(alg))
    theirs = _try(lambda: j_compressor.create(alg))
    assert mine[0] == theirs[0]
    if mine[0] == "raises":
        assert mine == theirs
        return
    blob = mine[1].compress(data)
    assert blob == theirs[1].compress(data)
    assert mine[1].decompress(blob) == data
    assert compressor.get_supported() == j_compressor.get_supported()


def test_log_dout_gathers_by_debug_level(capsys):
    log.dout("mon", 5, "no debug_mon option: not gathered")
    assert not log.should_gather("mon", 0)
    before = len(log.recent_entries(10000))
    log.derr("mon", "always kept")
    entries = log.recent_entries(10000)
    assert len(entries) == before + 1 and entries[-1][1:] == \
        ("mon", -1, "always kept")
    assert "[mon:ERR] always kept" in capsys.readouterr().err
    assert log.get_config is config.get_config


# -- the KV layer ----------------------------------------------------------


def _kv_generic(P, db):
    seen = []
    db.submit_transaction(
        P.KVTransaction().set("p", "a", b"1").set("p", "b", b"2"))
    seen.append([db.get("p", "a"), db.get("p", "b"), db.get("q", "a")])
    db.submit_transaction(P.KVTransaction().rmkey("p", "a"))
    seen.append([db.get("p", "a"), db.get("p", "b")])
    txn = P.KVTransaction()
    for k in ["c", "a", "b"]:
        txn.set("x", k, k.encode())
    txn.set("y", "zz", b"other")
    db.submit_transaction(txn)
    seen.append(list(db.get_iterator("x")))
    db.submit_transaction(P.KVTransaction().rmkeys_by_prefix("x"))
    seen.append([list(db.get_iterator("x")), list(db.get_iterator("y"))])
    db.submit_transaction(P.KVTransaction().set("p", "k", b"old"))
    db.submit_transaction(P.KVTransaction().set("p", "k", b"new"), sync=True)
    seen.append(db.get("p", "k"))
    return seen


@pytest.mark.parametrize("kind", ["memdb", "lsm"])
def test_kv_backend_matches_jax(kind, tmp_path):
    out = {}
    for P in BOTH:
        path = tmp_path / P.name
        db = P.kv.create(kind, str(path))
        db.open()
        out[P.name] = (_kv_generic(P, db), tree(path))
        db.close()
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == [b"1", b"2", None]
    assert out["port"][0][-1] == b"new"
    with pytest.raises(ValueError):
        kv.create("rocksdb")
    with pytest.raises(ValueError):
        kv.create("lsm")


def _lsm_replay(P, path):
    db = P.kv.create("lsm", path)
    db.open()
    db.submit_transaction(P.KVTransaction().set("p", "good", b"yes"),
                          sync=True)
    db.submit_transaction(P.KVTransaction().set("p", "more", b"m"),
                          sync=True)
    # crash: no close().  Torn tail: append garbage to the WAL.
    with open(os.path.join(path, "wal.log"), "ab") as f:
        f.write(GARBAGE)
    db2 = P.kv.create("lsm", path)
    db2.open()
    seen = [db2.get("p", "good"), db2.get("p", "more")]
    db2.close()
    return seen


def _torn_tail_then_synced_write(P, kind, path):
    """Crash, torn tail, remount, an acknowledged write, crash again: the
    second remount must read the acknowledged write."""
    if kind == "lsm":
        db = P.kv.create("lsm", path)
        db.open()
        db.submit_transaction(P.KVTransaction().set("p", "a", b"1"),
                              sync=True)
        log = os.path.join(path, "wal.log")
    else:
        s = P.os_mod.create(kind, path)
        s.queue_transaction(P.Transaction().write("a", 0, b"1"))
        log = {"filestore": os.path.join(path, "journal"),
               "kstore": os.path.join(path, "wal.log"),
               "blockstore": os.path.join(path, "kv", "wal.log")}[kind]
    with open(log, "ab") as f:
        f.write(GARBAGE)
    if kind == "lsm":
        db2 = P.kv.create("lsm", path)
        db2.open()
        db2.submit_transaction(P.KVTransaction().set("p", "b", b"2"),
                               sync=True)
        db3 = P.kv.create("lsm", path)
        db3.open()
        return [db3.get("p", "a"), db3.get("p", "b")]
    s2 = P.os_mod.create(kind, path)
    s2.queue_transaction(P.Transaction().write("b", 0, b"2"))
    s3 = P.os_mod.create(kind, path)
    return [s3.read("a") if s3.exists("a") else None,
            s3.read("b") if s3.exists("b") else None]


@pytest.mark.parametrize("kind", ["lsm", "filestore", "kstore",
                                  "blockstore"])
def test_torn_tail_is_cut_before_the_next_write(kind, tmp_path):
    """The port cuts a torn log tail off at mount, so what is written after
    it replays at the next mount.  The JAX package appends after the
    garbage: its kv-backed engines lose the acknowledged write (filestore
    has applied it before acknowledging, so it keeps it), and its
    blockstore, whose commits stay in the WAL's file buffer while the
    crashed store is open, loses both."""
    mine = _torn_tail_then_synced_write(PORT, kind, str(tmp_path / "port"))
    theirs = _torn_tail_then_synced_write(JAX, kind, str(tmp_path / "jax"))
    assert mine == [b"1", b"2"]
    assert theirs == {"filestore": [b"1", b"2"],
                      "blockstore": [None, None]}.get(kind, [b"1", None])


def _lsm_compact(P, path):
    db = P.kv.create("lsm", path)
    db.memtable_limit = 1024  # force flushes
    db.open()
    for i in range(100):
        db.submit_transaction(
            P.KVTransaction().set("p", f"k{i:03d}", _bytes(i, 32)))
    db.submit_transaction(P.KVTransaction().rmkey("p", "k000"))
    seen = [len(db._tables) > 1]
    db.compact()
    seen += [len(db._tables), db.get("p", "k000"), db.get("p", "k050"),
             len(list(db.get_iterator("p")))]
    db.close()
    db2 = P.kv.create("lsm", path)
    db2.open()
    seen += [db2.get("p", "k099"), db2.get("p", "k000")]
    db2.submit_transaction(P.KVTransaction().set("p", "k", b"v"))
    db2.flush()  # value now in an sstable
    db2.submit_transaction(P.KVTransaction().rmkey("p", "k"))
    seen += [db2.get("p", "k"), db2.get("p", "k001")]
    db2.close()
    return seen


@pytest.mark.parametrize("case", ["replay", "compact"])
def test_lsm_wal_replay_and_compaction_match_jax(case, tmp_path):
    fn = {"replay": _lsm_replay, "compact": _lsm_compact}[case]
    out = {P.name: (fn(P, str(tmp_path / P.name)), tree(tmp_path / P.name))
           for P in BOTH}
    if case == "replay":  # the port cut the torn tail off at open
        theirs = out["jax"][1]
        assert GARBAGE in theirs["wal.log"]
        theirs["wal.log"] = theirs["wal.log"].replace(GARBAGE, b"")
    assert out["port"] == out["jax"]
    seen = out["port"][0]
    if case == "replay":
        assert seen == [b"yes", b"m"]
    else:
        assert seen[:5] == [True, 1, None, _bytes(50, 32), 99]
        assert seen[5:] == [_bytes(99, 32), None, None, _bytes(1, 32)]


# -- store semantics, all backends, both packages ------------------------


def _write_read_stat(P, s):
    s.queue_transaction(P.Transaction().write("o1", 0, b"hello world"))
    return [s.read("o1"), s.read("o1", 6, 5), s.stat("o1"), s.exists("o1"),
            s.exists("nope"), _try(lambda: s.read("nope"))]


def _sparse_write_pads_zero(P, s):
    s.queue_transaction(P.Transaction().write("o", 100, b"x"))
    return [s.stat("o"), s.read("o", 0, 100) == b"\0" * 100]


def _overwrite_middle(P, s):
    s.queue_transaction(P.Transaction().write("o", 0, b"a" * 100))
    s.queue_transaction(P.Transaction().write("o", 10, b"B" * 5))
    return [s.read("o") == b"a" * 10 + b"B" * 5 + b"a" * 85]


def _truncate_shrink_and_extend(P, s):
    s.queue_transaction(P.Transaction().write("o", 0, b"x" * 100))
    s.queue_transaction(P.Transaction().truncate("o", 40))
    seen = [s.stat("o"), s.read("o") == b"x" * 40]
    s.queue_transaction(P.Transaction().truncate("o", 80))
    return seen + [s.stat("o"), s.read("o") == b"x" * 40 + b"\0" * 40]


def _xattrs(P, s):
    s.queue_transaction(P.Transaction().write("o", 0, b"d")
                        .setattr("o", "k", {"a": [1, 2]}))
    return [s.getattr("o", "k") == {"a": [1, 2]},
            s.getattr("o", "missing") is None]


def _remove(P, s):
    s.queue_transaction(P.Transaction().write("o", 0, b"d")
                        .setattr("o", "k", 1))
    s.queue_transaction(P.Transaction().remove("o"))
    return [not s.exists("o"), s.list_objects() == []]


def _multi_object_listing(P, s):
    txn = P.Transaction()
    for i in range(5):
        txn.write(f"obj{i}", 0, bytes([i]) * 10)
    s.queue_transaction(txn)
    return [s.list_objects() == [f"obj{i}" for i in range(5)]]


def _corrupt_hook(P, s):
    s.queue_transaction(P.Transaction().write("o", 0, b"\x00" * 16))
    s.corrupt("o", 3)
    return [s.read("o")[3] == 0xFF]


def _large_object_multi_stripe(P, s):
    # > one KStore stripe (64 KiB) to cross the chunking boundary
    blob = _bytes(3, 256 << 10)
    s.queue_transaction(P.Transaction().write("big", 0, blob))
    seen = [s.read("big") == blob,
            s.read("big", 65530, 12) == blob[65530:65530 + 12]]
    s.queue_transaction(P.Transaction().truncate("big", 70000))
    return seen + [s.read("big") == blob[:70000]]


def _omap_and_clone(P, s):
    txn = P.Transaction().write("o", 0, _bytes(4, 5000))
    txn.omap_setkeys("o", {"a": b"1", "b": b"2", "c": b"3"})
    s.queue_transaction(txn)
    s.queue_transaction(P.Transaction().omap_rmkeys("o", ["b"])
                        .clone("o", "o2").setattr("o2", "k", "v"))
    return [s.omap_get("o"), s.omap_get("o", ["a", "z"]), s.read("o2"),
            s.getattr("o2", "k"), s.omap_get("o2")]


STORE_CASES = {
    "write_read_stat": _write_read_stat,
    "sparse_write_pads_zero": _sparse_write_pads_zero,
    "overwrite_middle": _overwrite_middle,
    "truncate_shrink_and_extend": _truncate_shrink_and_extend,
    "xattrs": _xattrs,
    "remove": _remove,
    "multi_object_listing": _multi_object_listing,
    "corrupt_hook": _corrupt_hook,
    "large_object_multi_stripe": _large_object_multi_stripe,
    "omap_and_clone": _omap_and_clone,
}


STORE_WANT = {
    "write_read_stat": [b"hello world", b"world", 11, True, False,
                        ("raises", "FileNotFoundError")],
    "sparse_write_pads_zero": [101, True],
    "truncate_shrink_and_extend": [40, True, 80, True],
    "omap_and_clone": [{"a": b"1", "c": b"3"}, {"a": b"1"},
                       _bytes(4, 5000), "v", {}],
}


def _store_case(P, kind, case, path):
    s = P.os_mod.create(kind, str(path))
    seen = STORE_CASES[case](P, s)
    snap = snapshot(s)
    if hasattr(s, "umount"):
        s.umount()
    return seen, snap, tree(path)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_case_matches_jax(kind, case, tmp_path):
    """The JAX package's store suite, one case at a time on each engine:
    the same results, the same objects, xattrs and omap, and (for the
    persistent engines) the same file tree."""
    mine = _store_case(PORT, kind, case, tmp_path / "port")
    theirs = _store_case(JAX, kind, case, tmp_path / "jax")
    assert mine == theirs
    if case in STORE_WANT:
        assert mine[0] == STORE_WANT[case]
    else:
        assert all(x is True for x in mine[0]), mine[0]
    if kind in PERSISTENT:
        assert mine[2]  # the store wrote files


# -- persistence, crash recovery, cross-mount ----------------------------


def _txns(P):
    """A mixed sequence of transactions: big and small writes, sparse
    writes, overwrites in place, truncates, clones, xattrs, omap and a
    removal."""
    T = P.Transaction
    return [
        T().write("a", 0, _bytes(10, 200_000)).setattr("a", "_v", (1, "x")),
        T().write("b", 4096, _bytes(11, 3000)).omap_setkeys(
            "b", {"k1": b"v1", "k2": _bytes(12, 40)}),
        T().write("a", 5000, _bytes(13, 700)),        # small: deferred
        T().write("c", 0, b"Z" * 131072),             # compressible
        T().truncate("a", 150_000).clone("b", "b2"),
        T().write("c", 70_000, b"patch"),
        T().remove("b").omap_rmkeys("b2", ["k1"]),
        T().truncate("c", 200_000).setattr("c", "h", {"crc": [1, 2]}),
    ]


def _apply(P, kind, path, umount=True):
    s = P.os_mod.create(kind, str(path))
    for txn in _txns(P):
        s.queue_transaction(txn)
    snap = snapshot(s)
    if umount:
        s.umount()
    return snap


@pytest.mark.parametrize("kind", PERSISTENT)
def test_file_trees_equal_after_the_same_transactions(kind, tmp_path):
    snaps = {P.name: _apply(P, kind, tmp_path / P.name) for P in BOTH}
    assert snaps["port"] == snaps["jax"]
    assert sorted(snaps["port"]) == ["a", "b2", "c"]
    mine, theirs = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert sorted(mine) == sorted(theirs) and mine
    for name in mine:
        assert mine[name] == theirs[name], name


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
@pytest.mark.parametrize("kind", PERSISTENT)
def test_each_package_mounts_the_others_store(kind, direction, tmp_path):
    writer, reader = (JAX, PORT) if direction == "port_reads_jax" \
        else (PORT, JAX)
    path = tmp_path / "store"
    want = _apply(writer, kind, path)
    s = reader.os_mod.create(kind, str(path))
    assert snapshot(s) == want
    # the reader goes on writing where the writer stopped, and the writer
    # mounts the result again
    s.queue_transaction(reader.Transaction().write("a", 10, b"reader"))
    s.umount()
    back = writer.os_mod.create(kind, str(path))
    assert back.read("a", 10, 6) == b"reader"
    assert back.read("c") == want["c"][0]
    back.umount()


@pytest.mark.parametrize("kind", PERSISTENT)
def test_crash_without_umount_reads_every_acknowledged_write(kind, tmp_path):
    """No umount, and the crashed store still open (what a process killed
    mid-run leaves: nothing of its buffers flushed): each package remounts
    the port's crashed store and reads back every acknowledged
    transaction.  The JAX package's blockstore leaves its unsynced KV
    commits in the WAL's file buffer, so its own crashed blockstore is not
    held to this."""
    crashed = []
    for P in BOTH:
        path = tmp_path / P.name
        s = P.os_mod.create(kind, str(path))
        for txn in _txns(P):
            s.queue_transaction(txn)
        crashed.append(s)  # kept open: no finalizer flushes it
        want = snapshot(s)
        if P is JAX and kind.startswith("blockstore"):
            continue
        for Q in BOTH:
            assert snapshot(Q.os_mod.create(kind, str(path))) == want, \
                (P.name, Q.name)
    assert len(crashed) == 2


@pytest.mark.parametrize("kind", PERSISTENT)
def test_fsync_counts_equal(kind, tmp_path, monkeypatch):
    """Every fsync of the reference is kept: the same transactions (and a
    remount and umount) call ``os.fsync`` as often in both packages."""
    counts = {}
    real = os.fsync
    for P in BOTH:
        calls = []

        def counting(fd, calls=calls):
            calls.append(fd)
            return real(fd)

        monkeypatch.setattr(os, "fsync", counting)
        path = tmp_path / P.name
        _apply(P, kind, path)
        s = P.os_mod.create(kind, str(path))
        s.queue_transaction(P.Transaction().write("d", 0, b"sync"))
        s.umount()
        monkeypatch.setattr(os, "fsync", real)
        counts[P.name] = len(calls)
    assert counts["port"] == counts["jax"]
    # filestore fsyncs its journal and COMMITTED, kstore its WAL, on every
    # transaction; blockstore (in both packages) only at umount
    assert counts["port"] > (2 * len(_txns(PORT)) if kind == "filestore"
                             else len(_txns(PORT)) if kind == "kstore"
                             else 1)


def _filestore_journal_replay(P, path):
    """Crash between journal append and apply: remount must replay."""
    s = P.os_mod.create("filestore", path)
    s.queue_transaction(P.Transaction().write("o", 0, b"base"))
    txn = P.Transaction().write("o", 0, b"NEWDATA")
    record = P.enc.frame(P.encode_txn(s._seq + 1, txn))
    s._journal.write(record)
    s._journal.flush()
    os.fsync(s._journal.fileno())
    s._journal.close()  # crash: apply never ran, COMMITTED not bumped
    s2 = P.os_mod.create("filestore", path)
    seen = [s2.read("o")]
    s2.umount()
    return seen


def _filestore_torn_tail(P, path):
    s = P.os_mod.create("filestore", path)
    s.queue_transaction(P.Transaction().write("o", 0, b"good"))
    with open(s._journal_path, "ab") as f:
        f.write(GARBAGE)
    s._journal.close()
    s2 = P.os_mod.create("filestore", path)
    seen = [s2.read("o")]
    s2.umount()
    return seen


def _kstore_crash_replay(P, path):
    s = P.os_mod.create("kstore", path)
    s.queue_transaction(P.Transaction().write("o", 0, b"wal-covered"))
    # crash: no umount/close -- the LSM WAL alone must reconstruct state
    s2 = P.os_mod.create("kstore", path)
    seen = [s2.read("o")]
    s2.umount()
    return seen


def _kstore_truncate_then_remove(P, path):
    s = P.os_mod.create("kstore", path)
    s.queue_transaction(P.Transaction().write("o", 0, b"A" * 200_000))
    s.queue_transaction(P.Transaction().truncate("o", 0).remove("o"))
    seen = [s.exists("o"), list(s.db.get_iterator("D"))]
    s.queue_transaction(P.Transaction().write("o", 100_000, b"x"))
    seen.append(s.read("o", 65_000, 1_000) == b"\0" * 1_000)
    s.umount()
    return seen


def _remount(kind):
    def case(P, path):
        s = P.os_mod.create(kind, path)
        s.queue_transaction(P.Transaction().write("o", 0, b"persist me")
                            .setattr("o", "k", 7))
        s.umount()
        s2 = P.os_mod.create(kind, path)
        seen = [s2.read("o"), s2.getattr("o", "k")]
        s2.umount()
        return seen
    return case


def _blockstore_deferred_replay(P, path):
    """A deferred small overwrite whose in-place apply never happened
    (crash after the KV commit) replays at mount."""
    s = P.os_mod.create("blockstore", path)
    s.queue_transaction(P.Transaction().write("o", 0, b"A" * 100_000))
    phys0 = s._get_onode("o")["extents"][0]
    s.umount()
    s2 = P.os_mod.create("blockstore", path)
    rec = {"pofs": phys0 * s2.alloc_unit + 10, "data": b"XYZ"}
    s2.db.submit_transaction(P.KVTransaction().set(
        "D", f"{10**15:016d}", P.enc.Encoder().value(rec).bytes()))
    s2.umount()
    s3 = P.os_mod.create("blockstore", path)
    data = s3.read("o")
    seen = [data[10:13], data[:10], list(s3.db.get_iterator("D"))]
    s3.umount()
    return seen


def _blockstore_small_overwrite_deferred(P, path):
    s = P.os_mod.create("blockstore", path)
    s.queue_transaction(P.Transaction().write("o", 0, b"B" * 200_000))
    s.queue_transaction(P.Transaction().write("o", 5000, b"hello"))
    seen = [s.read("o", 5000, 5)]
    s.umount()
    s2 = P.os_mod.create("blockstore", path)
    seen += [s2.read("o", 5000, 5), s2.read("o", 0, 5)]
    s2.umount()
    return seen


def _blockstore_cow_frees_and_reuses(P, path):
    s = P.os_mod.create("blockstore", path)
    au = s.alloc_unit
    s.queue_transaction(P.Transaction().write("a", 0, b"1" * (2 * au)))
    used_before = set(s._get_onode("a")["extents"].values())
    s.queue_transaction(P.Transaction().write("a", 0, b"2" * (2 * au)))
    seen = [used_before & s._free == used_before]
    s.queue_transaction(P.Transaction().write("b", 0, b"3" * (2 * au)))
    seen.append(set(s._get_onode("b")["extents"].values()) <= used_before)
    s.umount()
    s2 = P.os_mod.create("blockstore", path)
    live = set(s2._get_onode("a")["extents"].values()) | set(
        s2._get_onode("b")["extents"].values())
    seen += [s2._free == set(range(s2._high_water)) - live,
             s2.read("a") == b"2" * (2 * au), sorted(s2._free)]
    s2.umount()
    return seen


def _blockstore_truncate_regrow(P, path):
    s = P.os_mod.create("blockstore", path)
    s.queue_transaction(P.Transaction().write("o", 0, b"Z" * 100_000))
    s.queue_transaction(P.Transaction().truncate("o", 40_000))
    s.queue_transaction(P.Transaction().truncate("o", 90_000))
    data = s.read("o")
    s.umount()
    return [data[:40_000] == b"Z" * 40_000, data[40_000:] == bytes(50_000)]


def _mkbs(P, path, **kw):
    return P.os_mod.BlockStore(path, alloc_unit=4096,
                               deferred_threshold=2048, **kw)


def _bs_compression_saves_units(P, path):
    s = _mkbs(P, path, compression="zlib")
    data = b"A" * 65536  # 16 units logical, compresses to ~1
    s.queue_transaction(P.Transaction().write("big", 0, data))
    blob = next(iter(s._get_onode("big")["cblobs"].values()))
    rnd = _bytes(5, 65536)
    s.queue_transaction(P.Transaction().write("rand", 0, rnd))
    seen = [s.read("big") == data, blob["span"] == 16,
            len(blob["phys"]) < 16, s.read("rand") == rnd,
            not s._get_onode("rand")["cblobs"]]
    s.umount()
    return seen


def _bs_compressed_survives_remount(P, path):
    s = _mkbs(P, path, compression="zlib")
    data = bytes(range(256)) * 256
    s.queue_transaction(P.Transaction().write("o", 0, data))
    used_before = s._high_water - len(s._free)
    s.umount()
    s2 = _mkbs(P, path)  # reopen WITHOUT compression
    seen = [s2.read("o") == data,
            s2._high_water - len(s2._free) == used_before]
    s2.umount()
    return seen


def _bs_partial_overwrite_explodes(P, path):
    s = _mkbs(P, path, compression="zlib")
    s.queue_transaction(P.Transaction().write("o", 0, b"B" * 32768))
    seen = [bool(s._get_onode("o")["cblobs"])]
    s.queue_transaction(P.Transaction().write("o", 5000, b"x" * 100))
    got = s.read("o")
    seen += [got == b"B" * 5000 + b"x" * 100 + b"B" * (32768 - 5100),
             not s._get_onode("o")["cblobs"]]
    s.umount()
    return seen


def _bs_compressed_csum(P, path):
    s = _mkbs(P, path, compression="zlib")
    s.queue_transaction(P.Transaction().write("o", 0, b"C" * 65536))
    s.corrupt("o", 8192)  # lands inside the blob payload
    seen = [_try(lambda: s.read("o"))]
    s.umount()
    return seen


def _bs_truncate_and_clone(P, path):
    s = _mkbs(P, path, compression="zlib")
    data = b"D" * 65536
    s.queue_transaction(P.Transaction().write("o", 0, data))
    s.queue_transaction(P.Transaction().clone("o", "o2"))
    seen = [s.read("o2") == data]
    s.queue_transaction(P.Transaction().truncate("o", 10_000))
    seen += [s.read("o") == b"D" * 10_000, s.read("o2") == data]
    s.queue_transaction(P.Transaction().write("o", 20_000, b"E"))
    seen.append(s.read("o")[10_000:20_000] == bytes(10_000))
    s.umount()
    return seen


def _bs_truncate_inside_blob_last_unit(P, path):
    s = _mkbs(P, path, compression="zlib")
    s.queue_transaction(P.Transaction().write("o", 0, b"F" * 65536))
    cut = 65536 - 100
    s.queue_transaction(P.Transaction().truncate("o", cut))
    s.queue_transaction(P.Transaction().truncate("o", 65536))
    got = s.read("o")
    s.umount()
    return [got[:cut] == b"F" * cut, got[cut:] == bytes(100)]


ENGINE_CASES = {
    "filestore_remount": _remount("filestore"),
    "kstore_remount": _remount("kstore"),
    "blockstore_remount": _remount("blockstore"),
    "filestore_journal_replay": _filestore_journal_replay,
    "filestore_torn_tail": _filestore_torn_tail,
    "kstore_crash_replay": _kstore_crash_replay,
    "kstore_truncate_then_remove": _kstore_truncate_then_remove,
    "blockstore_deferred_replay": _blockstore_deferred_replay,
    "blockstore_small_overwrite_deferred":
        _blockstore_small_overwrite_deferred,
    "blockstore_cow_frees_and_reuses": _blockstore_cow_frees_and_reuses,
    "blockstore_truncate_regrow": _blockstore_truncate_regrow,
    "blockstore_compression_saves_units": _bs_compression_saves_units,
    "blockstore_compressed_survives_remount":
        _bs_compressed_survives_remount,
    "blockstore_partial_overwrite_explodes": _bs_partial_overwrite_explodes,
    "blockstore_compressed_csum": _bs_compressed_csum,
    "blockstore_truncate_and_clone": _bs_truncate_and_clone,
    "blockstore_truncate_inside_blob_last_unit":
        _bs_truncate_inside_blob_last_unit,
}

WANT = {
    "filestore_journal_replay": [b"NEWDATA"],
    "filestore_torn_tail": [b"good"],
    "kstore_crash_replay": [b"wal-covered"],
    "kstore_truncate_then_remove": [False, [], True],
    "blockstore_deferred_replay": [b"XYZ", b"A" * 10, []],
    "blockstore_small_overwrite_deferred": [b"hello", b"hello", b"BBBBB"],
    "blockstore_compressed_csum": [("raises", "OSError")],
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_case_matches_jax(case, tmp_path):
    """The JAX package's engine-specific cases (journal replay and torn
    tail, the kstore WAL, blockstore's deferred writes, COW allocator and
    compressed blobs) on both packages: the same results, the same trees
    (where the case tore a log, the port's has the torn tail cut off)."""
    out = {}
    for P in BOTH:
        path = tmp_path / P.name
        out[P.name] = (ENGINE_CASES[case](P, str(path)), tree(path))
    if case == "filestore_torn_tail":
        theirs = out["jax"][1]
        assert GARBAGE in theirs["journal"]
        theirs["journal"] = theirs["journal"].replace(GARBAGE, b"")
    assert out["port"] == out["jax"]
    seen = out["port"][0]
    if case in WANT:
        assert seen == WANT[case]
    elif case in ("filestore_remount", "kstore_remount",
                  "blockstore_remount"):
        assert seen == [b"persist me", 7]
    else:
        assert all(x for x in seen if isinstance(x, bool)), seen


def test_factory_rejects_unknown_and_pathless():
    for P in BOTH:
        for kind in ("bluestore9000", "filestore", "kstore", "blockstore"):
            with pytest.raises(ValueError):
                P.os_mod.create(kind)
    assert isinstance(objectstore.create("memstore"), objectstore.MemStore)


def test_factory_takes_every_engine_and_the_compression_suffix(tmp_path):
    for kind, cls in [("filestore", objectstore.FileStore),
                      ("kstore", objectstore.KStore),
                      ("blockstore", objectstore.BlockStore)]:
        s = objectstore.create(kind, str(tmp_path / kind))
        assert type(s) is cls
        s.umount()
    s = objectstore.create("blockstore:zlib", str(tmp_path / "z"))
    assert s._comp is not None and s._comp.name == "zlib"
    s.umount()
    s = objectstore.create("blockstore", str(tmp_path / "z2"),
                           compression="bz2")
    assert s._comp.name == "bz2"
    s.umount()
    with pytest.raises(ModuleNotFoundError):
        objectstore.create("blockstore:zstd", str(tmp_path / "z3"))


# -- EC clusters over the persistent engines ----------------------------

CLUSTER_PROFILE = {"k": "2", "m": "1", "technique": "reed_sol_van"}


def _osd_snapshots(c) -> dict:
    return {osd.osd_id: snapshot(osd.store) for osd in c.osds}


async def _cluster_cycle(P, kind, path):
    c = P.make(4, CLUSTER_PROFILE, objectstore=kind, data_path=str(path))
    payload = _bytes(6, 6500)
    await c.write("obj", payload)
    seen = [await c.read("obj") == payload]
    c.kill_osd(0)
    seen.append(await c.read("obj") == payload)  # degraded read
    snap = _osd_snapshots(c)
    await c.shutdown()
    return seen, snap


@pytest.mark.parametrize("kind", PERSISTENT)
def test_cluster_on_persistent_store(kind, tmp_path):
    """The JAX package's ``test_cluster_on_persistent_store``: the port's
    cluster (``cuda`` plugin, profile ``device=cpu``) against the JAX
    package's, every OSD's objects, xattrs and omap equal."""
    out = {P.name: _run(_cluster_cycle(P, kind, tmp_path / P.name))
           for P in BOTH}
    assert out["port"] == out["jax"]
    assert out["port"][0] == [True, True]
    assert sum(len(s) for s in out["port"][1].values()) >= 3
    assert any(p.name.startswith("osd.")
               for p in (tmp_path / "port").iterdir())


def test_blockstore_cluster_crash_remount(tmp_path):
    """EC cluster on blockstore: abandon without umount (crash), remount
    a new cluster on the same path, read every object back; both
    packages' stores identical after each phase."""
    payloads = {f"o{i}": _bytes(20 + i, 30_000 + i) for i in range(4)}
    prof = {"k": "3", "m": "2"}

    async def write_phase(P, path):
        c = P.make(6, prof, objectstore="blockstore", data_path=str(path))
        for oid, p in payloads.items():
            await c.write(oid, p)
        snap = _osd_snapshots(c)
        await c.shutdown()  # crash: no store umount
        return snap

    async def read_phase(P, path):
        c = P.make(6, prof, objectstore="blockstore", data_path=str(path))
        got = {oid: await c.read(oid) for oid in payloads}
        snap = _osd_snapshots(c)
        await c.shutdown()
        return got, snap

    written = {P.name: _run(write_phase(P, tmp_path / P.name))
               for P in BOTH}
    assert written["port"] == written["jax"]
    read = {P.name: _run(read_phase(P, tmp_path / P.name)) for P in BOTH}
    assert read["port"] == read["jax"]
    assert read["port"][0] == payloads
    assert read["port"][1] == written["port"]
    # the JAX package remounts the port's crashed cluster too
    got, _ = _run(read_phase(JAX, tmp_path / "port"))
    assert got == payloads


# -- the durable cycle (osd/durable_bench.py, chip_smoke.py phase 3g) -----


def _durable(P, kind, path, mons, seed=7):
    payloads = cluster_bench.make_payloads(6, 20_000, seed)
    extra = {f"new{i}": _bytes(seed + i, 9000) for i in range(2)}
    prof = {"k": "4", "m": "2", "technique": "reed_sol_van"}

    async def make():
        if mons:
            return await P.with_mons(8, prof, objectstore=kind,
                                     data_path=str(path))
        return P.make(8, prof, objectstore=kind, data_path=str(path))

    async def main():
        r = await durable_bench.run_durable_cycle(
            make, payloads, extra, writers=3, data_path=str(path))
        c = r["cluster"]
        snap = _osd_snapshots(c)
        index = None
        if mons:
            objs = durable_bench.index_objects(12, 300, 4, seed)
            index = await durable_bench.run_index_pool(c, objs, writers=3)
            snap = _osd_snapshots(c)
        await c.shutdown()
        return r, snap, index

    return _run(main())


@pytest.mark.parametrize("kind", ["filestore", "kstore"])
def test_durable_cycle_matches_jax(kind, tmp_path):
    """The durable cycle without mons (chip_smoke.py phase 3g b) through
    both packages' clusters: every read checked inside, the same victim,
    and every OSD's objects, xattrs and omap identical after recovery."""
    mine, snap, _ = _durable(PORT, kind, tmp_path / "port", mons=False)
    theirs, want, _ = _durable(JAX, kind, tmp_path / "jax", mons=False)
    assert snap == want and snap
    assert mine["victim"] == theirs["victim"]
    assert mine["final"] == theirs["final"] and len(mine["final"]) == 8
    assert set(mine["steps_s"]) == set(durable_bench.STEPS) - \
        {"mon_failover"}
    assert mine["disk_after_recovery"]["bytes"] > \
        mine["disk_after_write"]["bytes"] > 0


def test_durable_cycle_with_mons_on_blockstore(tmp_path):
    """Phase 3g a and c at a small size: the mon-backed cluster on
    blockstore through the leader's failover, the crash, recovery and the
    replicated index pool.  The JAX package's blockstore cannot run this
    cycle (its commits stay in the WAL's file buffer while the crashed
    store is open: ``test_crash_without_umount_reads_every_acknowledged_
    write``), so every stored shard is held against the numpy
    ``jerasure`` encode of its object's final payload instead."""
    r, snap, index = _durable(PORT, "blockstore", tmp_path / "port",
                              mons=True)
    assert r["mon_leaders"]["before"] == 0
    assert r["mon_leaders"]["after"] in (1, 2)
    assert list(r["steps_s"]) == list(durable_bench.STEPS)
    assert index["copies_compared"] == 36
    ref = registry.instance().factory(
        "jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"})
    sinfo = ecutil.StripeInfo(4, 4 * ref.get_chunk_size(1))
    checked = 0
    for oid, payload in r["final"].items():
        buf = np.zeros(sinfo.logical_to_next_stripe_offset(len(payload)),
                       np.uint8)
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
        want = ecutil.encode(sinfo, ref, buf, range(6))
        for s in range(6):
            holders = [o for o, objs in snap.items() if f"{oid}@{s}" in objs]
            assert holders, (oid, s)
            for o in holders:
                assert snap[o][f"{oid}@{s}"][0] == want[s].tobytes()
                checked += 1
    assert checked >= 8 * 6
