"""The port's RGW gateway and multisite sync (``rgw/``) against the JAX
package's.

Each case of the JAX package's ``tests/test_rgw.py`` runs as the same
script through both packages in one process: the JAX package's
``ECCluster`` on its default plugin (``jerasure``, on the host) and the
port's on its default, the ``cuda`` plugin, with the profile key
``device=cpu`` (the kernels' plain versions); the gateway's metadata
rides a replicated pool on the same OSDs, as in the JAX package's cases.
Every HTTP answer (status, headers with the gateway's own port written
as ``<port>``, body) and every value a script reads back must be equal,
and so must every OSD's store at the end, in every zone the script made:
the shards, xattrs and omap of every object.  The gateway writes the
clock into index entries and upload ids (``rgw/gateway.py``'s
``time.time()``); both packages' clock is frozen at one value for each
case, and both packages' ``RGWGateway._upload_counter`` (a class
attribute) starts at 0.  Inputs are made from numpy seeds; the tolerance
is byte equality.
"""

import asyncio
import hashlib
import re
import socket
import types

import numpy as np
import pytest

from ceph_tpu import rgw as j_rgw
from ceph_tpu.osd import cluster as j_cluster
from ceph_tpu.rgw import gateway as j_gateway
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import rgw
from ceph_tpu_torch.osd import cluster, cluster_bench
from ceph_tpu_torch.rgw import gateway
from ceph_tpu_torch.utils.perf import PerfCounters
from torch_verify import port_verifiers, verifying_policy

PORT = types.SimpleNamespace(
    name="port", rgw=rgw, gateway=gateway, PerfCounters=PerfCounters,
    make=lambda n, prof: cluster.ECCluster(n, dict(prof, device="cpu")))
JAX = types.SimpleNamespace(
    name="jax", rgw=j_rgw, gateway=j_gateway, PerfCounters=JPerfCounters,
    make=lambda n, prof: j_cluster.ECCluster(n, dict(prof)))
BOTH = (PORT, JAX)
PROFILE = {"k": "2", "m": "1"}
ACCESS, SECRET = "testkey", "testsecret"
DATE = "Thu, 01 Jan 2026 00:00:00 GMT"
#: the frozen clock (seconds since the epoch) both gateways read
CLOCK = 1_767_225_600.0


@pytest.fixture(autouse=True)
def _frozen_clock(monkeypatch):
    """Both gateway modules read ``time.time`` only; each gets a clock
    that stands still, and each upload counter starts at 0."""
    for mod in (gateway, j_gateway):
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(time=lambda: CLOCK))
        monkeypatch.setattr(mod.RGWGateway, "_upload_counter", 0)


@pytest.fixture(autouse=True)
def _loop_policy():
    """Both packages' loops run under the port's verifiers
    (``tests/torch_verify.py``): its atomic-section verifier, which holds
    both packages' sections, and its residency verifier."""
    with port_verifiers():
        yield


def _run(coro, P=None):
    """Run ``coro`` on a new loop: the port's under this file's policy,
    the JAX package's (``P`` is ``JAX``) under the port's verifying
    policy, which holds the JAX package's sections too, for this call
    alone."""
    saved = asyncio.get_event_loop_policy()
    if P is JAX:
        asyncio.set_event_loop_policy(verifying_policy())
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()
        asyncio.set_event_loop_policy(saved)


def _both(scenario, n_osds=6):
    """Run ``scenario(P, mk, log)`` in each package (``mk()`` makes a
    cluster); assert equal logs and equal final stores of every cluster
    made; return the port's log."""
    out = {}
    for P in BOTH:
        P.PerfCounters.reset_all()
        log = []

        async def main(P=P, log=log):
            made = []

            def mk(n=n_osds):
                made.append(P.make(n, PROFILE))
                return made[-1]

            try:
                await scenario(P, mk, log)
                return [cluster_bench.store_snapshot(c) for c in made]
            finally:
                for c in made:
                    await c.shutdown()

        out[P.name] = (log, _run(main(), P))
    (log, snaps), (want_log, want_snaps) = out["port"], out["jax"]
    assert log == want_log
    assert len(snaps) == len(want_snaps)
    for snap, want in zip(snaps, want_snaps):
        assert snap == want
    return log


async def _raises(log, exc, coro):
    """Await ``coro``, which must raise ``exc``; log the exception."""
    with pytest.raises(exc) as info:
        await coro
    log.append((type(info.value).__name__, str(info.value)))


def _bytes(seed: int, n: int) -> bytes:
    return np.random.RandomState(seed).randint(
        0, 256, n, dtype=np.uint8).tobytes()




def _parse(raw: bytes, port: int):
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    hdrs = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        hdrs[k.strip().lower()] = v.strip().replace(f":{port}", ":<port>")
    return int(lines[0].split()[1]), hdrs, payload


async def _send(port: int, lines, body: bytes):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write("\r\n".join(lines).encode() + b"\r\n\r\n" + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return _parse(raw, port)


class Zone:
    """One zone's cluster, replicated index pool and gateway, with an
    S3 (SigV2 / SigV4) and Swift client that logs every answer."""

    def __init__(self, P, c, log):
        self.P, self.c, self.log = P, c, log
        self.index = c.add_pool("rgw.index", pool_type="replicated", size=3)
        self.gw = P.rgw.RGWGateway(c.backend, index_backend=self.index)
        self.port = None

    async def start(self, user=True):
        if user:
            await self.gw.create_user(ACCESS, SECRET, "Test User")
        self.port = await self.gw.start()
        return self

    async def s3(self, method, target, body=b"", secret=SECRET,
                 access=ACCESS, sign=True, ctype="", extra=None):
        lines = [f"{method} {target} HTTP/1.1", "Host: localhost",
                 f"Date: {DATE}", f"Content-Length: {len(body)}"]
        if ctype:
            lines.append(f"Content-Type: {ctype}")
        lines += [f"{k}: {v}" for k, v in (extra or {}).items()]
        if sign:
            sig = self.P.rgw.sign_v2(secret, method, target.partition("?")[0],
                                     DATE, ctype)
            lines.append(f"Authorization: AWS {access}:{sig}")
        got = await _send(self.port, lines, body)
        self.log.append(got)
        return got

    async def s3v4(self, method, target, body=b"", secret=SECRET,
                   access=ACCESS, amz_date="20260101T000000Z",
                   payload_signed=True):
        path, _, query = target.partition("?")
        params = dict(kv.partition("=")[::2] for kv in query.split("&")
                      if kv)
        payload_hash = (hashlib.sha256(body).hexdigest() if payload_signed
                        else "UNSIGNED-PAYLOAD")
        headers = {"host": "localhost", "x-amz-date": amz_date,
                   "x-amz-content-sha256": payload_hash}
        signed = ";".join(sorted(headers))
        sig = self.P.rgw.sign_v4(secret, method, path, params, headers,
                                 signed, payload_hash, amz_date)
        cred = f"{access}/{amz_date[:8]}/default/s3/aws4_request"
        lines = [f"{method} {target} HTTP/1.1", f"Content-Length: {len(body)}",
                 "Host: localhost", f"x-amz-date: {amz_date}",
                 f"x-amz-content-sha256: {payload_hash}",
                 "Authorization: AWS4-HMAC-SHA256 "
                 f"Credential={cred}, SignedHeaders={signed}, Signature={sig}"]
        got = await _send(self.port, lines, body)
        self.log.append(got)
        return got

    async def swift(self, method, target, body=b"", headers=None):
        lines = [f"{method} {target} HTTP/1.1", "Host: localhost",
                 f"Content-Length: {len(body)}"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        got = await _send(self.port, lines, body)
        self.log.append(got)
        return got

    async def stop(self):
        await self.gw.stop()


def _both_zones(scenario, zones=1):
    """``scenario(P, zs, log)`` with ``zones`` started gateways."""
    async def run(P, mk, log):
        zs = [await Zone(P, mk(), log).start(user=not i)
              for i in range(zones)]
        try:
            await scenario(P, zs, log)
        finally:
            for z in zs:
                await z.stop()

    return _both(run)


def _upload_id(body: bytes) -> str:
    return body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()


def test_signatures_equal_jax():
    args = (SECRET, "PUT", "/b/k", DATE, "text/plain", "abc==")
    assert rgw.sign_v2(*args) == j_rgw.sign_v2(*args)
    headers = {"host": "localhost", "x-amz-date": "20260101T000000Z",
               "x-amz-content-sha256": "UNSIGNED-PAYLOAD"}
    v4 = (SECRET, "GET", "/b/k", {"versionId": "3", "acl": ""}, headers,
          ";".join(sorted(headers)), "UNSIGNED-PAYLOAD", "20260101T000000Z")
    assert rgw.sign_v4(*v4) == j_rgw.sign_v4(*v4)


def test_bucket_and_object_lifecycle_equal_jax():
    payload = _bytes(30, 150_000)

    async def scenario(P, zs, log):
        z, = zs
        await z.s3("GET", "/")
        await z.s3("PUT", "/photos")
        await z.s3("PUT", "/photos")
        await z.s3("PUT", "/photos/cat.jpg", body=payload)
        await z.s3("GET", "/photos/cat.jpg")
        await z.s3("HEAD", "/photos/cat.jpg")
        await z.s3("PUT", "/photos/dog.png", body=b"woof")
        await z.s3("PUT", "/photos/notes.txt", body=b"text")
        await z.s3("GET", "/photos?prefix=")
        await z.s3("GET", "/photos?prefix=cat")
        await z.s3("GET", "/")
        await z.s3("DELETE", "/photos")
        for key in ("cat.jpg", "dog.png", "notes.txt"):
            await z.s3("DELETE", f"/photos/{key}")
        await z.s3("DELETE", "/photos")
        await z.s3("GET", "/photos")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 409, 200, 200, 200, 200,
                                        200, 200, 200, 200, 409, 204, 204,
                                        204, 204, 404]
    assert b"<ListAllMyBucketsResult>" in log[0][2]
    assert log[3][1]["etag"].strip('"') == hashlib.md5(payload).hexdigest()
    assert log[4][2] == payload and log[5][2] == b""
    assert log[5][1]["x-object-size"] == str(len(payload))
    assert log[8][2].count(b"<Contents>") == 3
    assert log[9][2].count(b"<Contents>") == 1 and b"BucketNotEmpty" in \
        log[11][2] and b"NoSuchBucket" in log[16][2]


def test_auth_failures_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.s3("GET", "/", sign=False)
        await z.s3("GET", "/", secret="wrong")
        await z.s3("GET", "/", access="nobody")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [403, 403, 403]
    assert b"AccessDenied" in log[0][2]
    assert b"SignatureDoesNotMatch" in log[1][2]
    assert b"AccessDenied" in log[2][2]


def test_errors_and_missing_objects_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.s3("GET", "/nope/key")
        await z.s3("PUT", "/b")
        await z.s3("GET", "/b/missing")
        await z.s3("DELETE", "/b/missing")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [404, 200, 404, 404]
    assert b"NoSuchBucket" in log[0][2] and b"NoSuchKey" in log[2][2]


def test_gateway_serves_degraded_equal_jax():
    blob = _bytes(31, 200_000)

    async def scenario(P, zs, log):
        z, = zs
        await z.s3("PUT", "/bk")
        await z.s3("PUT", "/bk/data", body=blob)
        z.c.kill_osd(z.c.backend.acting_set("rgw.obj.bk/data")[0])
        await z.s3("GET", "/bk/data")
        await z.s3("PUT", "/bk/more", body=b"mm")
        await z.s3("GET", "/bk/more")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 200, 200, 200]
    assert log[2][2] == blob and log[4][2] == b"mm"


def test_zero_byte_object_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.s3("PUT", "/b")
        await z.s3("PUT", "/b/marker/", body=b"")
        await z.s3("GET", "/b/marker/")
        await z.s3("DELETE", "/b/marker/")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 200, 204]
    assert log[2][2] == b""


def test_cross_tenant_access_denied_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.gw.create_user("mallory", "msecret")
        await z.s3("PUT", "/private")
        await z.s3("PUT", "/private/secret.txt", body=b"s3cr3t")
        for method, target in (
            ("GET", "/private/secret.txt"), ("PUT", "/private/x"),
            ("DELETE", "/private/secret.txt"), ("GET", "/private"),
            ("DELETE", "/private"),
        ):
            await z.s3(method, target, access="mallory", secret="msecret")
        await z.s3("GET", "/private/secret.txt")
        await z.s3("GET", "/", access="mallory", secret="msecret")

    log = _both_zones(scenario)
    assert all(s == 403 and b"AccessDenied" in b for s, _h, b in log[2:7])
    assert log[7][:1] == (200,) and log[7][2] == b"s3cr3t"
    assert log[8][0] == 200 and b"private" not in log[8][2]


def test_sigv4_auth_accepts_good_rejects_bad_equal_jax():
    data = _bytes(32, 5000)

    async def scenario(P, zs, log):
        z, = zs
        await z.s3v4("PUT", "/v4bucket")
        await z.s3v4("PUT", "/v4bucket/obj", body=data)
        await z.s3v4("GET", "/v4bucket/obj", payload_signed=False)
        await z.s3v4("GET", "/v4bucket/obj", secret="wrong")
        await z.s3v4("GET", "/v4bucket/obj", amz_date="20250101T000000Z",
                     access="nobody")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 200, 403, 403]
    assert log[2][2] == data and b"SignatureDoesNotMatch" in log[3][2]


def test_multipart_upload_lifecycle_equal_jax():
    parts = {n: _bytes(33 + n, 40_000 + n) for n in (1, 2, 3)}

    async def scenario(P, zs, log):
        z, = zs
        await z.s3("PUT", "/mp")
        _st, _h, body = await z.s3("POST", "/mp/big.bin?uploads")
        uid = _upload_id(body)
        for n in (2, 1, 3):
            await z.s3("PUT", f"/mp/big.bin?partNumber={n}&uploadId={uid}",
                       body=parts[n])
        await z.s3("GET", "/mp?uploads")
        plist = "".join(f"<Part><PartNumber>{n}</PartNumber></Part>"
                        for n in (1, 2, 3))
        await z.s3("POST", f"/mp/big.bin?uploadId={uid}",
                   body=f"<CompleteMultipartUpload>{plist}"
                        f"</CompleteMultipartUpload>".encode())
        await z.s3("GET", "/mp/big.bin")
        await z.s3("PUT", f"/mp/big.bin?partNumber=1&uploadId={uid}",
                   body=b"zzz")
        await z.s3("GET", "/mp?uploads")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200] * 8 + [404, 200]
    md5s = b"".join(hashlib.md5(parts[n]).digest() for n in (1, 2, 3))
    want = f"{hashlib.md5(md5s).hexdigest()}-3"
    assert f'<ETag>"{want}"'.encode() in log[6][2]
    assert log[7][2] == parts[1] + parts[2] + parts[3]
    assert log[7][1]["etag"].strip('"') == want
    assert b"NoSuchUpload" in log[8][2] and b"big.bin" in log[5][2]


def test_multipart_abort_cleans_up_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.s3("PUT", "/mp2")
        uid = _upload_id((await z.s3("POST", "/mp2/x?uploads"))[2])
        await z.s3("PUT", f"/mp2/x?partNumber=1&uploadId={uid}",
                   body=b"part-one")
        await z.s3("DELETE", f"/mp2/x?uploadId={uid}")
        await z.s3("GET", "/mp2/x")
        await z.s3("POST", f"/mp2/x?uploadId={uid}", body=b"")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 200, 204, 404, 404]
    assert b"NoSuchKey" in log[4][2] and b"NoSuchUpload" in log[5][2]


def test_bucket_delete_aborts_inflight_uploads_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.gw.create_user("other", "othersecret", "Other Tenant")
        await z.s3("PUT", "/shared")
        uid = _upload_id((await z.s3("POST", "/shared/secret?uploads"))[2])
        await z.s3("PUT", f"/shared/secret?partNumber=1&uploadId={uid}",
                   body=b"tenant-A-private-data")
        await z.s3("DELETE", "/shared")
        other = {"secret": "othersecret", "access": "other"}
        await z.s3("PUT", "/shared", **other)
        await z.s3("GET", "/shared?uploads", **other)
        await z.s3("POST", f"/shared/secret?uploadId={uid}", body=b"",
                   **other)
        log.append(uid)

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log[:-1]] == [200, 200, 200, 204, 200, 200,
                                             404]
    assert log[-1].encode() not in log[5][2]
    assert b"NoSuchUpload" in log[6][2]


# -- Swift --------------------------------------------------------------------


def test_swift_auth_and_object_lifecycle_equal_jax():
    payload = _bytes(37, 60_000)

    async def scenario(P, zs, log):
        z, = zs
        await z.swift("GET", "/auth/v1.0", headers={
            "X-Storage-User": f"{ACCESS}:swift", "X-Storage-Pass": "wrong"})
        _st, hdrs, _b = await z.swift("GET", "/auth/v1.0", headers={
            "X-Storage-User": f"{ACCESS}:swift", "X-Storage-Pass": SECRET})
        tok = {"X-Auth-Token": hdrs["x-auth-token"]}
        await z.swift("PUT", f"/v1/AUTH_{ACCESS}/cont")
        await z.swift("PUT", f"/v1/AUTH_{ACCESS}/cont", headers=tok)
        await z.swift("PUT", f"/v1/AUTH_{ACCESS}/cont/data.bin",
                      body=payload, headers=tok)
        await z.swift("GET", f"/v1/AUTH_{ACCESS}/cont/data.bin", headers=tok)
        await z.swift("GET", f"/v1/AUTH_{ACCESS}/cont", headers=tok)
        await z.swift("GET", f"/v1/AUTH_{ACCESS}", headers=tok)
        await z.s3("GET", "/cont/data.bin")
        await z.swift("DELETE", f"/v1/AUTH_{ACCESS}/cont/data.bin",
                      headers=tok)
        await z.swift("DELETE", f"/v1/AUTH_{ACCESS}/cont", headers=tok)

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [403, 200, 403, 201, 201, 200, 200,
                                        200, 200, 204, 204]
    assert log[1][1]["x-storage-url"] == \
        f"http://127.0.0.1:<port>/v1/AUTH_{ACCESS}"
    assert log[4][1]["etag"].strip('"') == hashlib.md5(payload).hexdigest()
    assert log[5][2] == payload == log[8][2]
    assert log[6][2] == b"data.bin\n" and log[7][2] == b"cont\n"


def test_swift_cross_account_denied_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.gw.create_user("other", "othersecret", "Other")
        _st, hdrs, _b = await z.swift("GET", "/auth/v1.0", headers={
            "X-Storage-User": "other:swift", "X-Storage-Pass": "othersecret"})
        await z.swift("PUT", f"/v1/AUTH_{ACCESS}/steal",
                      headers={"X-Auth-Token": hdrs["x-auth-token"]})

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 403]


# -- ACLs ---------------------------------------------------------------------


def test_acl_cross_account_grant_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        alice = {"access": "alice", "secret": "alicesecret"}
        await z.gw.create_user("alice", "alicesecret", "Alice")
        await z.s3("PUT", "/shared")
        await z.s3("PUT", "/shared/doc", body=b"grant me")
        await z.s3("GET", "/shared", **alice)
        await z.s3("GET", "/shared/doc", **alice)
        await z.s3("PUT", "/shared/doc?acl",
                   extra={"x-amz-grant-read": 'id="alice"'})
        await z.s3("GET", "/shared/doc", **alice)
        await z.s3("PUT", "/shared/doc2", body=b"x", **alice)
        await z.s3("PUT", "/shared?acl",
                   extra={"x-amz-grant-read": 'id="alice"'})
        await z.s3("GET", "/shared", **alice)
        await z.s3("GET", "/shared/doc?acl")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 403, 403, 200, 200, 403,
                                        200, 200, 200]
    assert log[5][2] == b"grant me" and b"doc" in log[8][2]
    assert b"<ID>alice</ID>" in log[9][2]


def test_acl_canned_public_and_authenticated_read_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        bob = {"access": "bob", "secret": "bobsecret"}
        await z.gw.create_user("bob", "bobsecret", "Bob")
        await z.s3("PUT", "/pub")
        await z.s3("PUT", "/pub/open", body=b"public bytes",
                   extra={"x-amz-acl": "public-read"})
        await z.s3("GET", "/pub/open", sign=False)
        await z.s3("PUT", "/pub/anon", body=b"x", sign=False)
        await z.s3("PUT", "/pub/authonly", body=b"auth bytes",
                   extra={"x-amz-acl": "authenticated-read"})
        await z.s3("GET", "/pub/authonly", **bob)
        await z.s3("GET", "/pub/authonly", sign=False)
        await z.s3("PUT", "/pub/closed", body=b"secret")
        await z.s3("GET", "/pub/closed", **bob)
        await z.s3("GET", "/pub/open?acl")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 200, 403, 200, 200, 403,
                                        200, 403, 200]
    assert log[2][2] == b"public bytes" and log[5][2] == b"auth bytes"
    assert b"AllUsers" in log[9][2] and b"READ" in log[9][2]


def test_acl_swift_container_read_cross_account_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.gw.create_user("carol", "carolsecret", "Carol")

        async def swift_auth(user, pw):
            _st, hdrs, _b = await z.s3(
                "GET", "/auth/v1.0", sign=False,
                extra={"X-Storage-User": f"{user}:{user}",
                       "X-Storage-Pass": pw})
            return hdrs["x-auth-token"]

        owner = {"X-Auth-Token": await swift_auth(ACCESS, SECRET)}
        carol = {"X-Auth-Token": await swift_auth("carol", "carolsecret")}
        await z.s3("PUT", f"/v1/AUTH_{ACCESS}/swiftbox", sign=False,
                   extra=dict(owner, **{"X-Container-Read": "carol"}))
        await z.s3("PUT", f"/v1/AUTH_{ACCESS}/swiftbox/o1", sign=False,
                   body=b"swift acl", extra=owner)
        await z.s3("GET", f"/v1/AUTH_{ACCESS}/swiftbox", sign=False,
                   extra=carol)
        await z.s3("GET", f"/v1/AUTH_{ACCESS}/swiftbox/o1", sign=False,
                   extra=carol)
        await z.s3("PUT", f"/v1/AUTH_{ACCESS}/swiftbox/evil", sign=False,
                   body=b"x", extra=carol)

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 201, 201, 200, 200, 403]
    assert b"o1" in log[4][2] and log[5][2] == b"swift acl"


def test_acl_reset_on_overwrite_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.s3("PUT", "/b")
        await z.s3("PUT", "/b/doc", body=b"open",
                   extra={"x-amz-acl": "public-read"})
        await z.s3("GET", "/b/doc", sign=False)
        await z.s3("PUT", "/b/doc", body=b"confidential")
        await z.s3("GET", "/b/doc", sign=False)

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 200, 200, 403]
    assert log[2][2] == b"open"


# -- object versioning --------------------------------------------------------


def test_object_versioning_lifecycle_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.s3("PUT", "/vb")
        await z.s3("PUT", "/vb?versioning", body=b"<Status>Enabled</Status>")
        await z.s3("GET", "/vb?versioning")
        v1 = (await z.s3("PUT", "/vb/doc", body=b"v one"))[1][
            "x-amz-version-id"]
        v2 = (await z.s3("PUT", "/vb/doc", body=b"v two"))[1][
            "x-amz-version-id"]
        await z.s3("GET", "/vb/doc")
        await z.s3("GET", f"/vb/doc?versionId={v1}")
        marker = (await z.s3("DELETE", "/vb/doc"))[1]["x-amz-version-id"]
        await z.s3("GET", "/vb/doc")
        await z.s3("GET", f"/vb/doc?versionId={v2}")
        await z.s3("GET", "/vb?versions")
        await z.s3("DELETE", f"/vb/doc?versionId={marker}")
        await z.s3("GET", "/vb/doc")
        await z.s3("DELETE", f"/vb/doc?versionId={v2}")
        await z.s3("GET", "/vb/doc")
        await z.s3("DELETE", "/vb/doc")
        await z.s3("DELETE", "/vb")
        log.append((v1, v2, marker))

    log = _both_zones(scenario)
    v1, v2, marker = log[-1]
    assert [s for s, _h, _b in log[:-1]] == [200, 200, 200, 200, 200, 200,
                                             200, 204, 404, 200, 200, 204,
                                             200, 204, 200, 204, 409]
    assert v2 > v1 and b"<Status>Enabled</Status>" in log[2][2]
    assert log[5][2] == b"v two" and log[6][2] == b"v one"
    assert log[7][1]["x-amz-delete-marker"] == "true"
    assert log[10][2].count(b"<Version>") == 2
    assert log[10][2].count(b"<DeleteMarker>") == 1
    assert f"<VersionId>{marker}</VersionId>".encode() in log[10][2]
    assert log[12][2] == b"v two" and log[14][2] == b"v one"
    assert b"BucketNotEmpty" in log[16][2]


def test_versioning_preserves_pre_versioning_object_equal_jax():
    async def scenario(P, zs, log):
        z, = zs
        await z.s3("PUT", "/nv")
        await z.s3("PUT", "/nv/doc", body=b"pre-versioning")
        await z.s3("PUT", "/nv?versioning", body=b"<Status>Enabled</Status>")
        v2 = (await z.s3("PUT", "/nv/doc", body=b"v2"))[1][
            "x-amz-version-id"]
        await z.s3("GET", "/nv")
        body = (await z.s3("GET", "/nv?versions"))[2]
        plain = sorted(re.findall(rb"<VersionId>(\d+)</VersionId>",
                                  body))[0].decode()
        await z.s3("GET", f"/nv/doc?versionId={plain}")
        await z.s3("DELETE", f"/nv/doc?versionId={v2}")
        await z.s3("GET", "/nv/doc")
        await z.s3("DELETE", "/nv/doc")
        await z.s3("DELETE", "/nv/doc")
        await z.s3("PUT", "/nv?versioning",
                   body=b"<Status>Suspended</Status>")
        await z.s3("GET", "/nv?versioning")

    log = _both_zones(scenario)
    assert [s for s, _h, _b in log] == [200, 200, 200, 200, 200, 200, 200,
                                        204, 200, 204, 204, 200, 200]
    assert b"doc" in log[4][2] and log[5][2].count(b"<Version>") == 2
    assert log[6][2] == b"pre-versioning" == log[8][2]
    assert log[10][1]["x-amz-delete-marker"] == "true"
    assert b"<Status>Suspended</Status>" in log[12][2]


# -- multisite sync -----------------------------------------------------------


def test_multisite_sync_converges_secondary_zone_equal_jax():
    async def scenario(P, zs, log):
        a, b = zs
        agent = P.rgw.RGWSyncAgent((a.c.backend, a.index),
                                   (b.c.backend, b.index))
        await a.s3("PUT", "/site")
        await a.s3("PUT", "/site/a.txt", body=b"alpha")
        await a.s3("PUT", "/site/pub", body=b"open",
                   extra={"x-amz-acl": "public-read"})
        await a.s3("PUT", "/site?versioning",
                   body=b"<Status>Enabled</Status>")
        await a.s3("PUT", "/site/v.txt", body=b"ver1")
        v_ver2 = (await a.s3("PUT", "/site/v.txt", body=b"ver2"))[1][
            "x-amz-version-id"]
        log.append(await agent.sync_once())
        await b.s3("GET", "/site/a.txt")
        await b.s3("GET", "/site/pub", sign=False)
        await b.s3("GET", "/site/v.txt")
        await b.s3("GET", "/site?versions")
        log.append(await agent.sync_once())
        await a.s3("PUT", "/site/a.txt", body=b"alpha2")
        await a.s3("DELETE", "/site/pub")
        log.append(await agent.sync_once())
        await b.s3("GET", "/site/a.txt")
        await b.s3("GET", "/site/pub", sign=False)
        await b.s3("GET", "/site/pub")
        await a.s3("DELETE", "/site/v.txt")
        log.append(await agent.sync_once())
        await b.s3("GET", "/site/v.txt")
        await b.s3("GET", f"/site/v.txt?versionId={v_ver2}")
        await a.s3("PUT", "/nb")
        await a.s3("PUT", "/nb/k", body=b"plainbody")
        log.append(await agent.sync_once())
        await a.s3("PUT", "/nb?versioning", body=b"<Status>Enabled</Status>")
        await a.s3("DELETE", "/nb/k")
        log.append(await agent.sync_once())
        body = (await a.s3("GET", "/nb?versions"))[2]
        pvid = re.findall(rb"<VersionId>(\d+)</VersionId>"
                          rb"<IsLatest>false</IsLatest>", body)[0].decode()
        for z in (a, b):
            await z.s3("GET", f"/nb/k?versionId={pvid}")

    log = _both_zones(scenario, zones=2)
    answers = [e for e in log if isinstance(e, tuple)]
    stats = [e for e in log if isinstance(e, dict)]
    assert stats[0]["objects_copied"] >= 3
    assert stats[1]["objects_copied"] == 0 == stats[1]["objects_deleted"]
    assert stats[2]["objects_copied"] == 1
    assert [(s, b) for s, _h, b in answers[6:10]][:3] == [
        (200, b"alpha"), (200, b"open"), (200, b"ver2")]
    assert answers[9][2].count(b"<Version>") == 2
    assert [s for s, _h, _b in answers[12:15]] == [200, 403, 404]
    assert answers[12][2] == b"alpha2"
    assert [(s, b) for s, _h, b in answers[16:18]] == [
        (404, answers[16][2]), (200, b"ver2")]
    assert [(s, b) for s, _h, b in answers[-2:]] == [(200, b"plainbody")] * 2


@pytest.mark.parametrize("server", ["rgw", "nbd"])
def test_failed_step_leaves_no_socket_bound(server):
    """A step that fails while a client holds a connection half-way
    through a request: the ``finally`` that stops the server returns
    (the handler is cancelled, not waited for) and the port is free
    again, so a failed check cannot hang the steps after it."""
    from ceph_tpu_torch.rbd import RBD
    from ceph_tpu_torch.rbd.nbd import NBDServer

    async def main():
        c = PORT.make(4, PROFILE)
        if server == "rgw":
            srv = rgw.RGWGateway(c.backend)
        else:
            await RBD(c.backend).create("disk", 1 << 20, order=16)
            srv = NBDServer(c.backend)
        port = await srv.start()
        writer = None
        try:
            with pytest.raises(AssertionError):
                try:
                    _reader, writer = await asyncio.open_connection(
                        "127.0.0.1", port)
                    writer.write(b"PUT /b/k HTTP/1.1\r\nContent-Len"
                                 if server == "rgw" else b"\0\0\0\2")
                    await writer.drain()
                    await asyncio.sleep(0.05)
                    assert False, "the step fails here"
                finally:
                    await asyncio.wait_for(srv.stop(), 10)
        finally:
            if writer is not None:
                writer.close()
            await c.shutdown()
        with socket.socket() as s:
            # as a server restarted on the port binds: only a listener
            # left behind (not the closed connection's TIME_WAIT) refuses
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
        with pytest.raises(ConnectionRefusedError):
            await asyncio.open_connection("127.0.0.1", port)

    _run(main())
