"""cephx-style keyring + handshake + message signing.

Port of ``ceph_tpu/auth/cephx.py``: the same keyring file format, proofs,
session keys and frame signatures, byte for byte.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
from typing import Dict, Optional


class AuthError(Exception):
    pass


class KeyRing:
    """Entity -> secret map (reference: src/auth/KeyRing.cc).

    File format is the ceph keyring INI subset::

        [osd.0]
            key = <base64>
        [client]
            key = <base64>
    """

    def __init__(self, keys: Optional[Dict[str, bytes]] = None):
        self._keys: Dict[str, bytes] = dict(keys or {})

    @staticmethod
    def generate_key() -> bytes:
        return os.urandom(32)

    def add(self, entity: str, key: Optional[bytes] = None) -> bytes:
        key = key if key is not None else self.generate_key()
        self._keys[entity] = key
        return key

    def get(self, entity: str) -> Optional[bytes]:
        return self._keys.get(entity)

    def remove(self, entity: str) -> None:
        """Revoke an entity's key (the `auth rm` flow)."""
        self._keys.pop(entity, None)

    def entities(self):
        return sorted(self._keys)

    # -- file I/O (ceph keyring INI subset) --------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for entity in sorted(self._keys):
                f.write(f"[{entity}]\n")
                key = base64.b64encode(self._keys[entity]).decode()
                f.write(f"\tkey = {key}\n")
        os.chmod(path, 0o600)

    @classmethod
    def load(cls, path: str) -> "KeyRing":
        keys: Dict[str, bytes] = {}
        entity = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("[") and line.endswith("]"):
                    entity = line[1:-1]
                elif line.startswith("key") and "=" in line and entity:
                    keys[entity] = base64.b64decode(
                        line.split("=", 1)[1].strip()
                    )
        return cls(keys)


def _mac(key: bytes, *parts: bytes) -> bytes:
    h = hmac.new(key, digestmod=hashlib.sha256)
    for p in parts:
        h.update(len(p).to_bytes(4, "little"))
        h.update(p)
    return h.digest()


class AuthHandshake:
    """Mutual challenge-response for one connection.

    Flow (client = connector, server = acceptor)::

        client -> server:  entity, client_nonce
        server -> client:  server_nonce, server_proof
        client -> server:  client_proof

    ``server_proof  = HMAC(secret, "srv", client_nonce, server_nonce)``
    ``client_proof  = HMAC(secret, "cli", client_nonce, server_nonce)``
    ``session_key   = HMAC(secret, "ses", client_nonce, server_nonce)``

    Each side verifies the other's proof before trusting the connection;
    the session key never crosses the wire.
    """

    def __init__(self, secret: bytes, client_nonce: bytes,
                 server_nonce: bytes):
        self.secret = secret
        self.client_nonce = client_nonce
        self.server_nonce = server_nonce

    @staticmethod
    def new_nonce() -> bytes:
        return os.urandom(16)

    def server_proof(self) -> bytes:
        return _mac(self.secret, b"srv", self.client_nonce,
                    self.server_nonce)

    def client_proof(self) -> bytes:
        return _mac(self.secret, b"cli", self.client_nonce,
                    self.server_nonce)

    def verify_server(self, proof: bytes) -> bool:
        return hmac.compare_digest(proof, self.server_proof())

    def verify_client(self, proof: bytes) -> bool:
        return hmac.compare_digest(proof, self.client_proof())

    def session_key(self) -> bytes:
        return _mac(self.secret, b"ses", self.client_nonce,
                    self.server_nonce)


def sign(session_key: bytes, payload: bytes) -> bytes:
    """Per-frame signature (ms_sign_messages role), truncated like the
    reference's 64-bit message signatures -- 16 bytes here."""
    return _mac(session_key, payload)[:16]


def sign_parts(session_key: bytes, parts) -> bytes:
    """:func:`sign` over a scatter-gather part list without joining it:
    the digest streams over each buffer, so
    ``sign_parts(k, [a, b]) == sign(k, a + b)`` (one pass, zero copies
    -- the corked messenger signs sealed frames straight off the part
    list)."""
    h = hmac.new(session_key, digestmod=hashlib.sha256)
    h.update(sum(len(p) for p in parts).to_bytes(4, "little"))
    for p in parts:
        h.update(p)
    return h.digest()[:16]


def verify(session_key: bytes, payload: bytes, sig: bytes) -> bool:
    return hmac.compare_digest(sig, sign(session_key, payload))
