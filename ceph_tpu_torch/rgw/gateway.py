"""S3 gateway frontend + RADOS mapping (reference src/rgw/rgw_main.cc,
rgw_rest_s3.cc, rgw_rados.cc).

Port of ``ceph_tpu/rgw/gateway.py``.

Supported S3 surface: service list (GET /), bucket create/delete/list
(PUT/DELETE/GET /<bucket>), object put/get/head/delete
(PUT/GET/HEAD/DELETE /<bucket>/<key>), prefix-filtered listing, ETags
(md5, as S3 defines for single-part uploads), multipart uploads
(initiate/part/complete/abort/list with the md5-of-md5s "-N" ETag),
AWS-v2 HMAC auth AND AWS SigV4 (AWS4-HMAC-SHA256 canonical
request/signing-key chain, signed or UNSIGNED-PAYLOAD), and the
matching S3 XML error envelopes (NoSuchBucket, NoSuchKey, NoSuchUpload,
SignatureDoesNotMatch, BucketAlreadyExists, BucketNotEmpty,
AccessDenied).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import re
import time
from typing import Dict, Optional, Tuple
from xml.sax.saxutils import escape

USERS_OID = "rgw.users"
BUCKETS_OID = "rgw.buckets"


def bucket_index_oid(bucket: str) -> str:
    return f"rgw.bucket.{bucket}"


def obj_oid(bucket: str, key: str) -> str:
    return f"rgw.obj.{bucket}/{key}"


def uploads_oid(bucket: str) -> str:
    # disjoint prefix: "rgw.bucket.<b>.uploads" would collide with the
    # index of a bucket literally named "<b>.uploads" (dots are legal)
    return f"rgw.uploads.{bucket}"


def acl_oid(bucket: str) -> str:
    """Per-bucket ACL store: omap key "@bucket" holds the bucket ACL,
    key "<obj>" an object ACL (reference: ACLs ride the bucket/object
    attrs, src/rgw/rgw_acl.h:1; stored form here is JSON).  Key
    "@versioning" holds the bucket versioning status."""
    return f"rgw.aclstore.{bucket}"


def versions_oid(bucket: str) -> str:
    """Per-bucket version index: omap key "<key>\\x00<vid>" -> metadata
    "<size>\\x00<etag>\\x00<ts>\\x00put|marker" (the reference keeps
    version instances as bucket-index olh entries, rgw_rados.cc
    RGWRados::Bucket::UpdateIndex + rgw_obj_key instances)."""
    return f"rgw.versions.{bucket}"


def ver_obj_oid(bucket: str, key: str, vid: str) -> str:
    return f"rgw.objver.{bucket}/{key}\x00{vid}"


#: canned ACLs -> grant lists (reference rgw_acl_s3.cc canned-ACL table)
CANNED_ACLS = {
    "private": [],
    "public-read": [{"grantee": "*", "perm": "READ"}],
    "public-read-write": [{"grantee": "*", "perm": "READ"},
                          {"grantee": "*", "perm": "WRITE"}],
    "authenticated-read": [{"grantee": "authenticated", "perm": "READ"}],
}


def acl_from_headers(headers: Dict[str, str], owner: str):
    """Build an ACL dict from x-amz-acl / x-amz-grant-* headers
    (rgw_acl_s3.cc create_canned + grant-header parsing); None when the
    request carries no ACL headers (keep default private)."""
    canned = headers.get("x-amz-acl", "")
    if canned and canned not in CANNED_ACLS:
        raise S3Error("InvalidRequest", f"bad canned acl {canned!r}")
    grants = list(CANNED_ACLS.get(canned, []))
    had_grant_hdr = bool(canned)
    for hdr, perm in (("x-amz-grant-read", "READ"),
                      ("x-amz-grant-write", "WRITE"),
                      ("x-amz-grant-full-control", "FULL_CONTROL")):
        for part in headers.get(hdr, "").split(","):
            part = part.strip()
            if not part:
                continue
            had_grant_hdr = True
            if part.startswith("id="):
                grants.append({"grantee": part[3:].strip('"'),
                               "perm": perm})
            elif part.endswith("AllUsers"):
                grants.append({"grantee": "*", "perm": perm})
            elif part.endswith("AuthenticatedUsers"):
                grants.append({"grantee": "authenticated", "perm": perm})
            else:
                raise S3Error("InvalidRequest", f"bad grantee {part!r}")
    if not had_grant_hdr:
        return None
    return {"owner": owner, "canned": canned or "custom", "grants": grants}


def acl_allows(acl: Optional[dict], requester: Optional[str],
               perm: str) -> bool:
    """Does ``acl`` grant ``perm`` to ``requester`` (None = anonymous)?
    The acl's own owner always has FULL_CONTROL."""
    if not acl:
        return False
    if requester is not None and acl.get("owner") == requester:
        return True
    for g in acl.get("grants", []):
        if g["perm"] not in (perm, "FULL_CONTROL"):
            continue
        gr = g["grantee"]
        if gr == "*" or gr == requester or (
            gr == "authenticated" and requester is not None
        ):
            return True
    return False


def acl_to_xml(acl: Optional[dict], owner: str) -> str:
    """AccessControlPolicy XML (GET ?acl; rgw_acl_s3.cc to_xml)."""
    grants = (acl or {}).get("grants", [])
    body = "".join(
        "<Grant><Grantee>"
        + (f"<URI>http://acs.amazonaws.com/groups/global/"
           f"{'AllUsers' if g['grantee'] == '*' else 'AuthenticatedUsers'}"
           "</URI>"
           if g["grantee"] in ("*", "authenticated")
           else f"<ID>{escape(g['grantee'])}</ID>")
        + f"</Grantee><Permission>{g['perm']}</Permission></Grant>"
        for g in grants
    )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        "<AccessControlPolicy>"
        f"<Owner><ID>{escape((acl or {}).get('owner') or owner)}</ID></Owner>"
        f"<AccessControlList>{body}</AccessControlList>"
        "</AccessControlPolicy>"
    )


def sign_v2(secret: str, method: str, resource: str, date: str,
            content_type: str = "", content_md5: str = "") -> str:
    """AWS signature v2 (the rgw_auth_s3.cc canonical string)."""
    to_sign = "\n".join([method, content_md5, content_type, date, resource])
    mac = hmac.new(secret.encode(), to_sign.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


def _hmac256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(secret: str, method: str, path: str, params: Dict[str, str],
            headers: Dict[str, str], signed_headers: str,
            payload_hash: str, amz_date: str,
            region: str = "default") -> str:
    """AWS signature v4 (rgw_auth_s3.cc get_v4_canonical_* chain).
    ``signed_headers`` is the semicolon-joined lowercase header list;
    ``payload_hash`` is the value of x-amz-content-sha256 (a hex digest
    or the UNSIGNED-PAYLOAD literal)."""
    canonical_q = "&".join(
        f"{k}={v}" for k, v in sorted(params.items()))
    names = signed_headers.split(";")
    canonical_h = "".join(
        f"{h}:{headers.get(h, '').strip()}\n" for h in names)
    creq = "\n".join([method, path, canonical_q, canonical_h,
                      signed_headers, payload_hash])
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    k = _hmac256(b"AWS4" + secret.encode(), amz_date[:8])
    for piece in (region, "s3", "aws4_request"):
        k = _hmac256(k, piece)
    return hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()


def _xml_error(code: str, message: str) -> str:
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        f"<Error><Code>{code}</Code>"
        f"<Message>{escape(message)}</Message></Error>"
    )


_ERROR_STATUS = {
    "NoSuchBucket": "404 Not Found",
    "NoSuchKey": "404 Not Found",
    "BucketAlreadyExists": "409 Conflict",
    "BucketNotEmpty": "409 Conflict",
    "SignatureDoesNotMatch": "403 Forbidden",
    "AccessDenied": "403 Forbidden",
    "InvalidRequest": "400 Bad Request",
    "NoSuchUpload": "404 Not Found",
}


class S3Error(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code


class RGWGateway:
    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 index_backend=None):
        self.backend = backend  # an Objecter (object-data pool, often EC)
        #: metadata plane (users / bucket list / bucket indexes / upload
        #: state): a SEPARATE pool handle when provided -- the reference
        #: keeps rgw metadata on replicated pools while data rides EC
        #: (rgw_rados.cc pool layout: .rgw.buckets.index et al.)
        self.index = index_backend if index_backend is not None else backend
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._serve_tasks: set = set()
        #: Swift auth tokens (X-Auth-Token -> (account, issued_at));
        #: the reference keeps these in its expiring token cache
        #: (rgw_swift_auth.cc)
        self._swift_tokens: Dict[str, tuple] = {}

    SWIFT_TOKEN_TTL = 3600.0

    # -- user admin (radosgw-admin user create role) -----------------------

    async def create_user(self, access: str, secret: str,
                          display: str = "") -> None:
        await self.index.omap_set(USERS_OID, {
            access: f"{secret}\x00{display}".encode(),
        })

    async def _secret_for(self, access: str) -> Optional[str]:
        got = await self.index.omap_get(USERS_OID, [access])
        if access not in got:
            return None
        return got[access].decode().split("\x00", 1)[0]

    # -- HTTP server -------------------------------------------------------

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # 3.12's wait_closed waits on live handlers: a client that
            # never finishes its request would hold it for good, so the
            # handlers are cancelled first (the JAX package waits)
            for task in list(self._serve_tasks):
                task.cancel()
            await asyncio.gather(*self._serve_tasks, return_exceptions=True)
            await self._server.wait_closed()

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._serve_tasks.add(task)
        try:
            req = await reader.readline()
            parts = req.split()
            if len(parts) < 2:
                return
            method, target = parts[0].decode(), parts[1].decode()
            headers: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", "0") or "0")
            if n:
                body = await reader.readexactly(n)
            try:
                status, ctype, out, extra = await self._handle(
                    method, target, headers, body
                )
            except S3Error as e:
                status = _ERROR_STATUS.get(e.code, "400 Bad Request")
                ctype = "application/xml"
                out = _xml_error(e.code, str(e)).encode()
                extra = {}
            except Exception as e:  # noqa: BLE001 -- internal error
                status, ctype = "500 Internal Server Error", "application/xml"
                out = _xml_error("InternalError", str(e)).encode()
                extra = {}
            hdr = (
                f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(out)}\r\nConnection: close\r\n"
            )
            for k, v in extra.items():
                hdr += f"{k}: {v}\r\n"
            writer.write(hdr.encode() + b"\r\n" + out)
            await writer.drain()
        finally:
            self._serve_tasks.discard(task)
            writer.close()

    # -- request routing (RGWHandler_REST_S3 dispatch) ---------------------

    async def _auth(self, method: str, resource: str,
                    headers: Dict[str, str],
                    path: str = "", params: Optional[Dict[str, str]] = None,
                    body: bytes = b"") -> str:
        auth = headers.get("authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            return await self._auth_v4(auth, method, path, params or {},
                                       headers, body)
        if not auth:
            # anonymous request (reference: rgw's anonymous user): only
            # resources with a public-read/-write grant will authorize
            return None
        if not auth.startswith("AWS "):
            raise S3Error("AccessDenied", "missing AWS authorization")
        try:
            access, sig = auth[4:].split(":", 1)
        except ValueError:
            raise S3Error("InvalidRequest", "malformed authorization")
        secret = await self._secret_for(access)
        if secret is None:
            raise S3Error("AccessDenied", f"no such access key {access!r}")
        want = sign_v2(
            secret, method, resource, headers.get("date", ""),
            headers.get("content-type", ""), headers.get("content-md5", ""),
        )
        if not hmac.compare_digest(want, sig):
            raise S3Error("SignatureDoesNotMatch", "bad signature")
        return access

    async def _auth_v4(self, auth: str, method: str, path: str,
                       params: Dict[str, str], headers: Dict[str, str],
                       body: bytes) -> str:
        """AWS SigV4 verification (rgw_auth_s3.cc AWSv4ComplMulti /
        get_v4_canonical_method): rebuild the canonical request from
        what actually arrived and compare signatures."""
        fields: Dict[str, str] = {}
        for piece in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = piece.strip().partition("=")
            fields[k] = v
        try:
            cred = fields["Credential"]
            signed_headers = fields["SignedHeaders"]
            sig = fields["Signature"]
            access, datestamp, region, svc, term = cred.split("/")
        except (KeyError, ValueError):
            raise S3Error("InvalidRequest", "malformed v4 authorization")
        if (svc, term) != ("s3", "aws4_request"):
            raise S3Error("InvalidRequest", f"bad credential scope {cred!r}")
        secret = await self._secret_for(access)
        if secret is None:
            raise S3Error("AccessDenied", f"no such access key {access!r}")
        amz_date = headers.get("x-amz-date", "")
        if not amz_date.startswith(datestamp):
            raise S3Error("InvalidRequest", "x-amz-date outside scope")
        payload_hash = headers.get("x-amz-content-sha256",
                                   "UNSIGNED-PAYLOAD")
        if payload_hash not in ("UNSIGNED-PAYLOAD",
                                hashlib.sha256(body).hexdigest()):
            raise S3Error("SignatureDoesNotMatch", "payload hash mismatch")
        want = sign_v4(secret, method, path, params, headers,
                       signed_headers, payload_hash, amz_date, region)
        if not hmac.compare_digest(want, sig):
            raise S3Error("SignatureDoesNotMatch", "bad v4 signature")
        return access

    @staticmethod
    def _split_target(target: str) -> Tuple[str, str, Dict[str, str]]:
        path, _, query = target.partition("?")
        params = {}
        for kv in query.split("&"):
            if kv:
                k, _, v = kv.partition("=")
                params[k] = v
        path = path.lstrip("/")
        bucket, _, key = path.partition("/")
        return bucket, key, params

    async def _bucket_owner(self, bucket: str) -> str:
        got = await self.index.omap_get(BUCKETS_OID, [bucket])
        if bucket not in got:
            raise S3Error("NoSuchBucket", bucket)
        return got[bucket].decode().split("\x00", 1)[0]

    async def _check_owner(self, bucket: str, owner) -> None:
        """Bucket-owner-only authorization (bucket delete, ACL writes)."""
        if owner is None or await self._bucket_owner(bucket) != owner:
            raise S3Error(
                "AccessDenied", f"bucket {bucket!r} is not yours"
            )

    async def _check_access(self, bucket: str, owner, perm: str,
                            key: str = None) -> None:
        """ACL authorization (reference src/rgw/rgw_acl.h:1 +
        rgw_op.cc verify_permission): the bucket owner has full
        control; otherwise the object ACL (if any), then the bucket
        ACL, must grant ``perm`` to ``owner`` (None = anonymous)."""
        import json as _json

        if owner is not None and await self._bucket_owner(bucket) == owner:
            return
        # keyed fetch: only the two relevant ACLs, never the whole store
        want = ["@bucket"] + ([key] if key is not None else [])
        acls = await self.index.omap_get(acl_oid(bucket), want)

        def load(k):
            raw = acls.get(k)
            return _json.loads(raw) if raw else None

        if key is not None and acl_allows(load(key), owner, perm):
            return
        if acl_allows(load("@bucket"), owner, perm):
            return
        raise S3Error(
            "AccessDenied",
            f"{owner or 'anonymous'} has no {perm} on "
            f"{bucket + ('/' + key if key else '')!r}"
        )

    async def _store_acl(self, bucket: str, key: str,
                         acl: Optional[dict]) -> None:
        import json as _json

        if acl is not None:
            await self.index.omap_set(
                acl_oid(bucket),
                {key or "@bucket": _json.dumps(acl).encode()},
            )

    async def _load_acl(self, bucket: str, key: str):
        import json as _json

        got = await self.index.omap_get(
            acl_oid(bucket), [key or "@bucket"])
        raw = got.get(key or "@bucket")
        return _json.loads(raw) if raw else None

    async def _handle(self, method, target, headers, body):
        # Swift routing needs more than the path prefix: an S3 bucket
        # may legitimately be NAMED "v1" or "auth", and its signed
        # requests must not be diverted into the Swift stack
        auth = headers.get("authorization", "")
        if target.startswith(("/auth/", "/v1/")) and not \
                auth.startswith(("AWS ", "AWS4-HMAC-SHA256 ")):
            return await self._handle_swift(method, target, headers, body)
        bucket, key, params = self._split_target(target)
        resource = "/" + bucket + ("/" + key if key else "")
        path = target.partition("?")[0]
        owner = await self._auth(method, resource, headers,
                                 path=path, params=params, body=body)
        if not bucket:
            if method == "GET" and owner is not None:
                return await self._list_buckets(owner)
            raise S3Error("AccessDenied" if owner is None else
                          "InvalidRequest", f"{method} on service root")
        if not key:
            if "versioning" in params:
                # bucket versioning config (reference rgw olh versioning;
                # `PUT ?versioning` owner-only, like S3)
                if method == "PUT":
                    await self._check_owner(bucket, owner)
                    status = (b"Enabled" if b"Enabled" in body
                              else b"Suspended")
                    await self.index.omap_set(
                        acl_oid(bucket), {"@versioning": status})
                    return "200 OK", "application/xml", b"", {}
                if method == "GET":
                    await self._check_owner(bucket, owner)
                    got = await self.index.omap_get(
                        acl_oid(bucket), ["@versioning"])
                    status = (got.get("@versioning") or b"").decode()
                    xml = ('<?xml version="1.0" encoding="UTF-8"?>'
                           "<VersioningConfiguration>"
                           + (f"<Status>{status}</Status>" if status
                              else "")
                           + "</VersioningConfiguration>")
                    return "200 OK", "application/xml", xml.encode(), {}
            if method == "GET" and "versions" in params:
                await self._check_access(bucket, owner, "READ")
                return await self._list_versions(bucket)
            if method == "PUT" and "acl" in params:
                # PUT /bucket?acl: replace the bucket ACL (owner only)
                await self._check_owner(bucket, owner)
                acl = acl_from_headers(headers, owner)
                await self._store_acl(
                    bucket, "",
                    acl or {"owner": owner, "canned": "private",
                            "grants": []})
                return "200 OK", "application/xml", b"", {}
            if method == "GET" and "acl" in params:
                await self._check_access(bucket, owner, "FULL_CONTROL")
                xml = acl_to_xml(await self._load_acl(bucket, ""),
                                 await self._bucket_owner(bucket))
                return "200 OK", "application/xml", xml.encode(), {}
            if method == "PUT":
                if owner is None:
                    raise S3Error("AccessDenied", "anonymous create")
                out = await self._create_bucket(bucket, owner)
                await self._store_acl(
                    bucket, "", acl_from_headers(headers, owner))
                return out
            if method == "DELETE":
                await self._check_owner(bucket, owner)
                return await self._delete_bucket(bucket)
            if method == "GET":
                # listing needs a READ grant (canned public-read /
                # authenticated-read / explicit x-amz-grant-read)
                await self._check_access(bucket, owner, "READ")
                if "uploads" in params:
                    return await self._list_uploads(bucket)
                return await self._list_objects(
                    bucket, params.get("prefix", "")
                )
            raise S3Error("InvalidRequest", f"{method} on bucket")
        if "acl" in params:
            # object ACL subresource: owner or FULL_CONTROL grantee
            if owner is None or await self._bucket_owner(bucket) != owner:
                await self._check_access(bucket, owner, "FULL_CONTROL", key)
            if method == "PUT":
                acl = acl_from_headers(headers, owner)
                await self._store_acl(
                    bucket, key,
                    acl or {"owner": owner, "canned": "private",
                            "grants": []})
                return "200 OK", "application/xml", b"", {}
            if method == "GET":
                xml = acl_to_xml(await self._load_acl(bucket, key),
                                 await self._bucket_owner(bucket))
                return "200 OK", "application/xml", xml.encode(), {}
            raise S3Error("InvalidRequest", f"{method} on ?acl")
        if method in ("GET", "HEAD"):
            await self._check_access(bucket, owner, "READ", key)
        else:
            # PUT/POST/DELETE on objects need a WRITE grant on the bucket
            await self._check_access(bucket, owner, "WRITE")
        # multipart upload surface (rgw_multipart: initiate/part/
        # complete/abort)
        if method == "POST" and "uploads" in params:
            return await self._initiate_multipart(bucket, key)
        if method == "POST" and "uploadId" in params:
            return await self._complete_multipart(
                bucket, key, params["uploadId"], body)
        if method == "PUT" and "uploadId" in params:
            try:
                part = int(params.get("partNumber", "0"))
            except ValueError:
                raise S3Error("InvalidRequest",
                              f"bad partNumber {params['partNumber']!r}")
            return await self._upload_part(
                bucket, key, params["uploadId"], part, body)
        if method == "DELETE" and "uploadId" in params:
            return await self._abort_multipart(
                bucket, key, params["uploadId"])
        if method == "PUT":
            out = await self._put_object(bucket, key, body)
            acl = acl_from_headers(headers, owner)
            if acl is not None:
                await self._store_acl(bucket, key, acl)
            else:
                # S3 semantics: an overwrite without ACL headers resets
                # the object to default-private -- the previous object's
                # grants must not apply to the new content
                await self.index.omap_rm(acl_oid(bucket), [key])
            return out
        if method == "GET":
            return await self._get_object(
                bucket, key, version_id=params.get("versionId"))
        if method == "HEAD":
            return await self._head_object(
                bucket, key, version_id=params.get("versionId"))
        if method == "DELETE":
            return await self._delete_object(
                bucket, key, version_id=params.get("versionId"))
        raise S3Error("InvalidRequest", f"{method} on object")

    # -- Swift API (rgw_rest_swift.cc + rgw_swift_auth.cc subset) ----------
    #
    # TempAuth flow: GET /auth/v1.0 with X-Storage-User "<account>:<user>"
    # (the access key) + X-Storage-Pass (the secret) returns X-Auth-Token
    # and X-Storage-Url; data ops are /v1/AUTH_<account>/<container>[/obj]
    # with the token header.  Containers map onto the same bucket
    # objects the S3 side uses, so both protocols see one namespace
    # (the reference stores Swift containers as rgw buckets too).

    async def _handle_swift(self, method, target, headers, body):
        path = target.partition("?")[0]
        if path == "/auth/v1.0":
            user = headers.get("x-storage-user", "")
            access = user.split(":", 1)[0]
            secret = await self._secret_for(access)
            if secret is None or not hmac.compare_digest(
                    headers.get("x-storage-pass", ""), secret):
                raise S3Error("AccessDenied", "bad swift credentials")
            now = time.time()
            # expire old tokens (the reference's token cache ages
            # entries out; an immortal dict would leak AND keep stolen
            # tokens valid forever)
            self._swift_tokens = {
                t: (acct, ts) for t, (acct, ts) in
                self._swift_tokens.items()
                if now - ts < self.SWIFT_TOKEN_TTL
            }
            tok = "AUTH_tk" + hashlib.sha256(
                f"{access}:{secret}:{now}".encode()).hexdigest()[:32]
            self._swift_tokens[tok] = (access, now)
            return "200 OK", "text/plain", b"", {
                "X-Auth-Token": tok,
                "X-Storage-Url": f"http://{self.host}:{self.port}"
                                 f"/v1/AUTH_{access}",
            }
        ent = self._swift_tokens.get(headers.get("x-auth-token", ""))
        if ent is None or time.time() - ent[1] >= self.SWIFT_TOKEN_TTL:
            raise S3Error("AccessDenied", "missing or expired auth token")
        owner = ent[0]
        parts = path.split("/", 4)  # ['', 'v1', 'AUTH_x', container, obj]
        if len(parts) < 3 or not parts[2].startswith("AUTH_"):
            raise S3Error("AccessDenied", "bad storage path")
        container = parts[3] if len(parts) > 3 else ""
        obj = parts[4] if len(parts) > 4 else ""
        if parts[2] != f"AUTH_{owner}":
            # another account's path: readable iff its container/object
            # ACL grants READ (the X-Container-Read role,
            # rgw_rest_swift.cc + rgw_acl_swift.cc)
            if method not in ("GET", "HEAD") or not container:
                raise S3Error("AccessDenied",
                              "token does not match account")
            await self._check_access(container, owner, "READ",
                                     obj or None)
            if not obj:
                return await self._swift_list_container(container)
            if method == "GET":
                return await self._get_object(container, obj)
            return await self._head_object(container, obj)
        if not container:
            if method == "GET":  # account listing: containers, plain text
                buckets = await self.index.omap_get(BUCKETS_OID)
                mine = sorted(
                    n for n, raw in buckets.items()
                    if raw.decode().split("\x00", 1)[0] == owner)
                return "200 OK", "text/plain", \
                    ("\n".join(mine) + "\n" if mine else "").encode(), {}
            raise S3Error("InvalidRequest", f"{method} on account")
        if not obj:
            if method in ("PUT", "POST"):
                if method == "PUT":
                    try:
                        await self._create_bucket(container, owner)
                    except S3Error as e:
                        if e.code != "BucketAlreadyExists":
                            raise
                        # idempotent ONLY for the owner: 201 on someone
                        # else's container would be a silent false success
                        await self._check_owner(container, owner)
                else:
                    await self._check_owner(container, owner)
                # X-Container-Read (rgw_acl_swift.cc): ".r:*" = public
                # read, otherwise a comma list of granted accounts
                read_acl = headers.get("x-container-read", "")
                if read_acl:
                    grants = []
                    for part in read_acl.split(","):
                        part = part.strip()
                        if part in (".r:*", ".rlistings"):
                            grants.append(
                                {"grantee": "*", "perm": "READ"})
                        elif part:
                            grants.append(
                                {"grantee": part.split(":")[-1],
                                 "perm": "READ"})
                    await self._store_acl(container, "", {
                        "owner": owner, "canned": "swift",
                        "grants": grants})
                return ("201 Created" if method == "PUT"
                        else "204 No Content"), "text/plain", b"", {}
            await self._check_owner(container, owner)
            if method == "DELETE":
                await self._delete_bucket(container)
                return "204 No Content", "text/plain", b"", {}
            if method == "GET":  # object listing, plain text
                return await self._swift_list_container(container)
            raise S3Error("InvalidRequest", f"{method} on container")
        await self._check_owner(container, owner)
        if method == "PUT":
            status, ctype, out, extra = await self._put_object(
                container, obj, body)
            return "201 Created", ctype, out, extra
        if method == "GET":
            return await self._get_object(container, obj)
        if method == "HEAD":
            return await self._head_object(container, obj)
        if method == "DELETE":
            return await self._delete_object(container, obj)
        raise S3Error("InvalidRequest", f"{method} on object")

    async def _swift_list_container(self, container: str):
        """Plain-text Swift object listing (shared by the own-account and
        cross-account read paths so the format cannot diverge)."""
        index = await self.index.omap_get(bucket_index_oid(container))
        names = sorted(index)
        return "200 OK", "text/plain", \
            ("\n".join(names) + "\n" if names else "").encode(), {}

    # -- bucket ops (rgw_bucket.cc) ----------------------------------------

    async def _bucket_exists(self, bucket: str) -> bool:
        got = await self.index.omap_get(BUCKETS_OID, [bucket])
        return bucket in got

    async def _list_buckets(self, owner: str):
        buckets = await self.index.omap_get(BUCKETS_OID)
        mine = [
            n for n, raw in buckets.items()
            if raw.decode().split("\x00", 1)[0] == owner
        ]
        items = "".join(
            f"<Bucket><Name>{escape(n)}</Name></Bucket>"
            for n in sorted(mine)
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<ListAllMyBucketsResult>"
            f"<Owner><ID>{escape(owner)}</ID></Owner>"
            f"<Buckets>{items}</Buckets></ListAllMyBucketsResult>"
        )
        return "200 OK", "application/xml", xml.encode(), {}

    async def _create_bucket(self, bucket: str, owner: str):
        if await self._bucket_exists(bucket):
            raise S3Error("BucketAlreadyExists", bucket)
        await self.index.omap_set(BUCKETS_OID, {
            bucket: f"{owner}\x00{int(time.time())}".encode(),
        })
        return "200 OK", "application/xml", b"", {}

    async def _delete_bucket(self, bucket: str):
        if not await self._bucket_exists(bucket):
            raise S3Error("NoSuchBucket", bucket)
        index = await self.index.omap_get(bucket_index_oid(bucket))
        if index:
            raise S3Error("BucketNotEmpty", bucket)
        vers = await self.index.omap_get(versions_oid(bucket))
        if any(k != "_seq" for k in vers):
            # versions (incl. delete markers) still exist: S3 refuses
            raise S3Error("BucketNotEmpty", f"{bucket} (versions remain)")
        await self.index.omap_clear(versions_oid(bucket))
        # abort any in-progress multipart uploads: leaving their parts
        # behind would let a future same-name bucket's owner complete
        # the previous tenant's upload and read its data
        try:
            ups = await self.index.omap_get(uploads_oid(bucket))
        except (FileNotFoundError, IOError):
            ups = {}
        for upload_id, raw_key in ups.items():
            key = raw_key.decode()
            try:
                meta = await self.index.omap_get(
                    self._mp_meta_oid(bucket, key, upload_id))
                await self._drop_upload(bucket, key, upload_id, meta)
            except (FileNotFoundError, IOError):
                pass
        await self.index.omap_rm(BUCKETS_OID, [bucket])
        # drop the ACL store with the bucket: a future same-name bucket
        # must not inherit the previous tenant's grants
        await self.index.omap_clear(acl_oid(bucket))
        return "204 No Content", "application/xml", b"", {}

    async def _list_objects(self, bucket: str, prefix: str):
        if not await self._bucket_exists(bucket):
            raise S3Error("NoSuchBucket", bucket)
        index = await self.index.omap_get(bucket_index_oid(bucket))
        items = []
        for k in sorted(index):
            if not k.startswith(prefix):
                continue
            # versioned entries carry a 4th (vid) field
            size, etag = index[k].decode().split("\x00")[:2]
            items.append(
                f"<Contents><Key>{escape(k)}</Key><Size>{size}</Size>"
                f'<ETag>"{etag}"</ETag></Contents>'
            )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f"<ListBucketResult><Name>{escape(bucket)}</Name>"
            f"<Prefix>{escape(prefix)}</Prefix>"
            f"{''.join(items)}</ListBucketResult>"
        )
        return "200 OK", "application/xml", xml.encode(), {}

    # -- object ops (rgw_rados.cc put/get paths) ---------------------------

    # -- versioning (reference rgw olh/versioning, rgw_rados.cc) ----------

    async def _versioning_enabled(self, bucket: str) -> bool:
        got = await self.index.omap_get(acl_oid(bucket), ["@versioning"])
        return got.get("@versioning") == b"Enabled"

    async def _next_vid(self, bucket: str) -> str:
        """Monotonic per-bucket version id (CAS-allocated, so racing
        PUTs get distinct ids; zero-padded so lexicographic order is
        chronological)."""
        while True:
            cur = await self.index.omap_get(versions_oid(bucket), ["_seq"])
            have = int(cur["_seq"]) if "_seq" in cur else 0
            ok, _ = await self.index.omap_cas(
                versions_oid(bucket), "_seq", cur.get("_seq"),
                str(have + 1).encode())
            if ok:
                return f"{have + 1:010d}"

    async def _archive_plain_current(self, bucket: str, key: str) -> None:
        """A pre-versioning (plain) current object must survive as a
        version when versioning operations replace or delete it (the S3
        'null version' role): it becomes a version whose data stays at
        the plain oid (kind 'plain')."""
        got = await self.index.omap_get(bucket_index_oid(bucket), [key])
        if key not in got:
            return
        parts = got[key].decode().split("\x00")
        if len(parts) > 3:
            return  # already version-pointing
        avid = await self._next_vid(bucket)
        await self.index.omap_set(versions_oid(bucket), {
            f"{key}\x00{avid}":
                f"{parts[0]}\x00{parts[1]}\x00{parts[2]}\x00plain".encode(),
        })

    async def _store_version(self, bucket: str, key: str, body: bytes,
                             etag: str) -> str:
        """Archive ``body`` as a new version and point the bucket index
        at it (every PUT to a versioned bucket creates a version)."""
        await self._archive_plain_current(bucket, key)
        vid = await self._next_vid(bucket)
        ts = int(time.time())
        await self.backend.write(ver_obj_oid(bucket, key, vid), body)
        await self.index.omap_set(versions_oid(bucket), {
            f"{key}\x00{vid}":
                f"{len(body)}\x00{etag}\x00{ts}\x00put".encode(),
        })
        await self.index.omap_set(bucket_index_oid(bucket), {
            key: f"{len(body)}\x00{etag}\x00{ts}\x00{vid}".encode(),
        })
        return vid

    async def _put_object(self, bucket: str, key: str, body: bytes):
        if not await self._bucket_exists(bucket):
            raise S3Error("NoSuchBucket", bucket)
        etag = hashlib.md5(body).hexdigest()
        if await self._versioning_enabled(bucket):
            vid = await self._store_version(bucket, key, body, etag)
            return "200 OK", "application/xml", b"", {
                "ETag": f'"{etag}"', "x-amz-version-id": vid}
        # data first, then the index entry (the reference's bucket-index
        # prepare/complete keeps the index authoritative)
        await self.backend.write(obj_oid(bucket, key), body)
        await self.index.omap_set(bucket_index_oid(bucket), {
            key: f"{len(body)}\x00{etag}\x00{int(time.time())}".encode(),
        })
        return "200 OK", "application/xml", b"", {"ETag": f'"{etag}"'}

    async def _index_entry(self, bucket: str, key: str):
        """-> (size, etag, current version id | None for plain objects)."""
        if not await self._bucket_exists(bucket):
            raise S3Error("NoSuchBucket", bucket)
        got = await self.index.omap_get(bucket_index_oid(bucket), [key])
        if key not in got:
            raise S3Error("NoSuchKey", key)
        parts = got[key].decode().split("\x00")
        return int(parts[0]), parts[1], parts[3] if len(parts) > 3 else None

    async def _version_meta(self, bucket: str, key: str, vid: str):
        got = await self.index.omap_get(
            versions_oid(bucket), [f"{key}\x00{vid}"])
        raw = got.get(f"{key}\x00{vid}")
        if raw is None:
            raise S3Error("NoSuchKey", f"{key} versionId={vid}")
        size_s, etag, ts, kind = raw.decode().split("\x00")
        return int(size_s), etag, kind

    async def _get_object(self, bucket: str, key: str,
                          version_id: Optional[str] = None):
        if version_id is not None:
            _size, etag, kind = await self._version_meta(
                bucket, key, version_id)
            if kind == "marker":
                raise S3Error("NoSuchKey", f"{key} (delete marker)")
            data = await self.backend.read(
                obj_oid(bucket, key) if kind == "plain"
                else ver_obj_oid(bucket, key, version_id))
            return "200 OK", "application/octet-stream", data, {
                "ETag": f'"{etag}"', "x-amz-version-id": version_id}
        size, etag, vid = await self._index_entry(bucket, key)
        data = await self.backend.read(
            ver_obj_oid(bucket, key, vid) if vid else obj_oid(bucket, key))
        hdrs = {"ETag": f'"{etag}"'}
        if vid:
            hdrs["x-amz-version-id"] = vid
        return "200 OK", "application/octet-stream", data, hdrs

    async def _head_object(self, bucket: str, key: str,
                           version_id: Optional[str] = None):
        if version_id is not None:
            size, etag, kind = await self._version_meta(
                bucket, key, version_id)
            if kind == "marker":
                raise S3Error("NoSuchKey", f"{key} (delete marker)")
        else:
            size, etag, _vid = await self._index_entry(bucket, key)
        return "200 OK", "application/octet-stream", b"", {
            "ETag": f'"{etag}"', "X-Object-Size": str(size),
        }

    async def _list_versions(self, bucket: str):
        """GET /bucket?versions -> ListVersionsResult (Version +
        DeleteMarker entries, newest first per key)."""
        if not await self._bucket_exists(bucket):
            raise S3Error("NoSuchBucket", bucket)
        vers = await self.index.omap_get(versions_oid(bucket))
        newest: Dict[str, str] = {}
        for vk in vers:
            if vk == "_seq":
                continue
            key, _, vid = vk.rpartition("\x00")
            if vid > newest.get(key, ""):
                newest[key] = vid
        items = []
        for vk in sorted(vers, reverse=True):
            if vk == "_seq":
                continue
            key, _, vid = vk.rpartition("\x00")
            size_s, etag, ts, kind = vers[vk].decode().split("\x00")
            latest = "true" if newest.get(key) == vid else "false"
            if kind == "marker":
                items.append(
                    f"<DeleteMarker><Key>{escape(key)}</Key>"
                    f"<VersionId>{vid}</VersionId>"
                    f"<IsLatest>{latest}</IsLatest></DeleteMarker>")
            else:
                items.append(
                    f"<Version><Key>{escape(key)}</Key>"
                    f"<VersionId>{vid}</VersionId>"
                    f"<IsLatest>{latest}</IsLatest>"
                    f"<Size>{size_s}</Size>"
                    f'<ETag>"{etag}"</ETag></Version>')
        xml = ('<?xml version="1.0" encoding="UTF-8"?>'
               f"<ListVersionsResult><Name>{escape(bucket)}</Name>"
               + "".join(items) + "</ListVersionsResult>")
        return "200 OK", "application/xml", xml.encode(), {}

    # -- multipart upload (reference rgw multipart meta objects:
    # RGWMultipartUpload in rgw_multi.cc -- an upload id names a meta
    # object tracking parts; complete concatenates them and the S3
    # multipart ETag is md5-of-part-md5s with a part count suffix) -----

    _upload_counter = 0

    @staticmethod
    def _mp_meta_oid(bucket: str, key: str, upload_id: str) -> str:
        return f"rgw.mp.{bucket}/{key}.{upload_id}"

    @staticmethod
    def _mp_part_oid(bucket: str, key: str, upload_id: str,
                     part: int) -> str:
        return f"rgw.mp.{bucket}/{key}.{upload_id}.{part:05d}"

    async def _initiate_multipart(self, bucket: str, key: str):
        RGWGateway._upload_counter += 1
        upload_id = hashlib.md5(
            f"{bucket}/{key}/{time.time()}/{self._upload_counter}".encode()
        ).hexdigest()
        await self.index.omap_set(
            self._mp_meta_oid(bucket, key, upload_id),
            {"_meta": f"{int(time.time())}".encode()})
        # track in-progress uploads on the bucket (list-uploads surface)
        await self.index.omap_set(uploads_oid(bucket), {
            upload_id: key.encode()})
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<InitiateMultipartUploadResult>"
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
            "</InitiateMultipartUploadResult>"
        )
        return "200 OK", "application/xml", xml.encode(), {}

    async def _upload_meta(self, bucket: str, key: str, upload_id: str):
        meta = await self.index.omap_get(
            self._mp_meta_oid(bucket, key, upload_id))
        if "_meta" not in meta:
            raise S3Error("NoSuchUpload", upload_id)
        return meta

    async def _upload_part(self, bucket: str, key: str, upload_id: str,
                           part: int, body: bytes):
        if part < 1 or part > 10000:
            raise S3Error("InvalidRequest", f"bad part number {part}")
        await self._upload_meta(bucket, key, upload_id)
        etag = hashlib.md5(body).hexdigest()
        await self.backend.write(
            self._mp_part_oid(bucket, key, upload_id, part), body)
        await self.index.omap_set(
            self._mp_meta_oid(bucket, key, upload_id),
            {f"part.{part:05d}": f"{len(body)}\x00{etag}".encode()})
        return "200 OK", "application/xml", b"", {"ETag": f'"{etag}"'}

    async def _complete_multipart(self, bucket: str, key: str,
                                  upload_id: str, body: bytes):
        meta = await self._upload_meta(bucket, key, upload_id)
        parts = sorted(
            (int(k.split(".")[1]), v.decode().split("\x00"))
            for k, v in meta.items() if k.startswith("part."))
        if not parts:
            raise S3Error("InvalidRequest", "no parts uploaded")
        # honor the client's part list when provided (S3 allows
        # completing with a subset); minimal XML scrape
        listed = [int(n) for n in re.findall(
            r"<PartNumber>(\d+)</PartNumber>", body.decode("utf-8",
                                                           "ignore"))]
        if listed:
            chosen = set(listed)
            missing = chosen - {p for p, _ in parts}
            if missing:
                raise S3Error("InvalidRequest",
                              f"parts never uploaded: {sorted(missing)}")
            parts = [(p, info) for p, info in parts if p in chosen]
        blob = bytearray()
        md5s = b""
        for part, (size, etag) in parts:
            data = await self.backend.read(
                self._mp_part_oid(bucket, key, upload_id, part))
            blob += data
            md5s += bytes.fromhex(etag)
        final_etag = f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"
        extra_hdrs = {}
        if await self._versioning_enabled(bucket):
            extra_hdrs["x-amz-version-id"] = await self._store_version(
                bucket, key, bytes(blob), final_etag)
        else:
            await self.backend.write(obj_oid(bucket, key), bytes(blob))
            await self.index.omap_set(bucket_index_oid(bucket), {
                key: f"{len(blob)}\x00{final_etag}\x00"
                     f"{int(time.time())}".encode(),
            })
        # a completed upload REPLACES the object: default-private, the
        # previous object's grants must not carry over
        await self.index.omap_rm(acl_oid(bucket), [key])
        await self._drop_upload(bucket, key, upload_id, meta)
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<CompleteMultipartUploadResult>"
            f"<Key>{escape(key)}</Key>"
            f'<ETag>"{final_etag}"</ETag>'
            "</CompleteMultipartUploadResult>"
        )
        return "200 OK", "application/xml", xml.encode(), extra_hdrs

    async def _abort_multipart(self, bucket: str, key: str,
                               upload_id: str):
        meta = await self._upload_meta(bucket, key, upload_id)
        await self._drop_upload(bucket, key, upload_id, meta)
        return "204 No Content", "application/xml", b"", {}

    async def _drop_upload(self, bucket: str, key: str, upload_id: str,
                           meta: Dict[str, bytes]) -> None:
        for k in meta:
            if k.startswith("part."):
                try:
                    await self.backend.remove_object(self._mp_part_oid(
                        bucket, key, upload_id, int(k.split(".")[1])))
                except IOError:
                    pass
        await self.index.omap_rm(
            self._mp_meta_oid(bucket, key, upload_id), list(meta))
        await self.index.omap_rm(
            uploads_oid(bucket), [upload_id])

    async def _list_uploads(self, bucket: str):
        try:
            ups = await self.index.omap_get(
                uploads_oid(bucket))
        except (FileNotFoundError, IOError):
            ups = {}
        items = "".join(
            f"<Upload><Key>{escape(v.decode())}</Key>"
            f"<UploadId>{u}</UploadId></Upload>"
            for u, v in sorted(ups.items()))
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            "<ListMultipartUploadsResult>"
            f"<Bucket>{escape(bucket)}</Bucket>{items}"
            "</ListMultipartUploadsResult>"
        )
        return "200 OK", "application/xml", xml.encode(), {}

    async def _delete_object(self, bucket: str, key: str,
                             version_id: Optional[str] = None):
        if version_id is not None:
            # permanent removal of ONE version (S3 DELETE ?versionId);
            # if it was current, the newest surviving put-version is
            # promoted (or the key disappears from the plain namespace)
            _s, _e, kind = await self._version_meta(bucket, key, version_id)
            await self.index.omap_rm(
                versions_oid(bucket), [f"{key}\x00{version_id}"])
            if kind != "marker":
                try:
                    await self.backend.remove_object(
                        obj_oid(bucket, key) if kind == "plain"
                        else ver_obj_oid(bucket, key, version_id))
                except IOError:
                    pass
            have_entry, cur = False, None
            try:
                _size, _etag, cur = await self._index_entry(bucket, key)
                have_entry = True
            except S3Error:
                pass
            if (have_entry and cur == version_id) or not have_entry:
                # the removed version was current -- or a delete marker
                # was on top (no plain-namespace entry): surface the
                # newest surviving version.  A PLAIN current entry
                # (have_entry, cur None) stays untouched.
                await self._promote_latest_version(bucket, key)
            return "204 No Content", "application/xml", b"", {}
        if await self._versioning_enabled(bucket):
            # versioned delete: a DELETE MARKER becomes the latest
            # version; older versions stay readable by id (S3 semantics,
            # reference olh delete-marker instances).  Idempotent like
            # S3: deleting an already-hidden (or never-written) key
            # still answers 204 and stacks a marker.
            if not await self._bucket_exists(bucket):
                raise S3Error("NoSuchBucket", bucket)
            await self._archive_plain_current(bucket, key)
            vid = await self._next_vid(bucket)
            await self.index.omap_set(versions_oid(bucket), {
                f"{key}\x00{vid}":
                    f"0\x00\x00{int(time.time())}\x00marker".encode(),
            })
            await self.index.omap_rm(bucket_index_oid(bucket), [key])
            await self.index.omap_rm(acl_oid(bucket), [key])
            return "204 No Content", "application/xml", b"", {
                "x-amz-version-id": vid, "x-amz-delete-marker": "true"}
        await self._index_entry(bucket, key)  # NoSuchKey check
        await self.index.omap_rm(bucket_index_oid(bucket), [key])
        await self.index.omap_rm(acl_oid(bucket), [key])  # its object ACL
        try:
            await self.backend.remove_object(obj_oid(bucket, key))
        except IOError:
            pass  # zero-byte object: nothing was written
        return "204 No Content", "application/xml", b"", {}

    async def _promote_latest_version(self, bucket: str, key: str) -> None:
        """Re-point the plain-namespace index at the newest surviving
        put-version of ``key`` (after its current version was removed);
        a marker or nothing on top hides the key."""
        vers = await self.index.omap_get(versions_oid(bucket))
        best = None  # (vid, meta)
        for vk, raw in vers.items():
            if vk == "_seq":
                continue
            k, _, vid = vk.rpartition("\x00")
            if k != key:
                continue
            if best is None or vid > best[0]:
                best = (vid, raw)
        if best is None:
            await self.index.omap_rm(bucket_index_oid(bucket), [key])
            return
        size_s, etag, ts, kind = best[1].decode().split("\x00")
        if kind == "marker":
            await self.index.omap_rm(bucket_index_oid(bucket), [key])
            return
        if kind == "plain":
            # the archived pre-versioning object resurfaces as a plain
            # current (its data still lives at the plain oid)
            await self.index.omap_set(bucket_index_oid(bucket), {
                key: f"{size_s}\x00{etag}\x00{ts}".encode()})
            await self.index.omap_rm(
                versions_oid(bucket), [f"{key}\x00{best[0]}"])
            return
        await self.index.omap_set(bucket_index_oid(bucket), {
            key: f"{size_s}\x00{etag}\x00{ts}\x00{best[0]}".encode(),
        })
