"""The port's cephx (``auth/cephx.py``) against the JAX package's.

With the same secret and nonces both packages make byte-identical
server and client proofs, session keys and frame signatures (the
streaming ``sign_parts`` equal to ``sign`` over the joined parts); a
keyring saved by one package loads in the other; a tampered proof,
payload or signature is refused by both.  Secrets and nonces are made
with numpy from a seed.
"""

import numpy as np
import pytest

from ceph_tpu.auth import cephx as j_cephx
from ceph_tpu_torch import auth
from ceph_tpu_torch.auth import cephx


def _bytes(rng, n):
    return rng.randint(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_handshake_and_signatures_byte_identical(seed):
    rng = np.random.RandomState(seed)
    secret, cn, sn = _bytes(rng, 32), _bytes(rng, 16), _bytes(rng, 16)
    mine = cephx.AuthHandshake(secret, cn, sn)
    theirs = j_cephx.AuthHandshake(secret, cn, sn)
    assert mine.server_proof() == theirs.server_proof()
    assert mine.client_proof() == theirs.client_proof()
    assert mine.session_key() == theirs.session_key()
    assert mine.server_proof() != mine.client_proof()
    # each side verifies the other package's proofs
    assert mine.verify_server(theirs.server_proof())
    assert theirs.verify_client(mine.client_proof())
    key = mine.session_key()
    parts = [_bytes(rng, int(n)) for n in rng.randint(0, 5000, size=5)]
    joined = b"".join(parts)
    sig = cephx.sign(key, joined)
    assert len(sig) == 16
    assert sig == j_cephx.sign(key, joined) == cephx.sign_parts(key, parts) \
        == j_cephx.sign_parts(key, parts)
    assert cephx.verify(key, joined, j_cephx.sign(key, joined))
    assert j_cephx.verify(key, joined, sig)


def test_tampering_is_detected_by_both():
    rng = np.random.RandomState(7)
    secret, cn, sn = _bytes(rng, 32), _bytes(rng, 16), _bytes(rng, 16)
    for mod in (cephx, j_cephx):
        hs = mod.AuthHandshake(secret, cn, sn)
        wrong = mod.AuthHandshake(_bytes(rng, 32), cn, sn)
        assert not hs.verify_server(wrong.server_proof())
        assert not hs.verify_client(wrong.client_proof())
        # a proof for other nonces (a replayed handshake) is refused
        replay = mod.AuthHandshake(secret, cn, _bytes(rng, 16))
        assert not hs.verify_client(replay.client_proof())
        assert not hs.verify_server(hs.client_proof())  # roles differ
        key = hs.session_key()
        payload = _bytes(rng, 300)
        sig = mod.sign(key, payload)
        flipped = bytearray(payload)
        flipped[17] ^= 1
        assert not mod.verify(key, bytes(flipped), sig)
        assert not mod.verify(key, payload, sig[:-1] + bytes([sig[-1] ^ 1]))
        assert not mod.verify(wrong.session_key(), payload, sig)


def test_keyring_crosses_packages(tmp_path):
    rng = np.random.RandomState(11)
    keys = {f"osd.{i}": _bytes(rng, 32) for i in range(4)}
    keys["client"] = _bytes(rng, 32)
    mine = cephx.KeyRing(dict(keys))
    mine.add("mon.0", _bytes(rng, 32))
    mine.remove("osd.3")
    theirs = j_cephx.KeyRing(dict(keys))
    theirs.add("mon.0", mine.get("mon.0"))
    theirs.remove("osd.3")
    a, b = tmp_path / "port.keyring", tmp_path / "jax.keyring"
    mine.save(str(a))
    theirs.save(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert oct(a.stat().st_mode & 0o777) == oct(b.stat().st_mode & 0o777) \
        == "0o600"
    back = cephx.KeyRing.load(str(b))
    j_back = j_cephx.KeyRing.load(str(a))
    assert back.entities() == j_back.entities() == mine.entities()
    for ent in mine.entities():
        assert back.get(ent) == j_back.get(ent) == mine.get(ent)
    assert back.get("osd.3") is None
    assert len(cephx.KeyRing.generate_key()) == 32


def test_auth_package_exports():
    assert auth.KeyRing is cephx.KeyRing
    assert auth.AuthHandshake is cephx.AuthHandshake
    assert auth.AuthError is cephx.AuthError
    assert (auth.sign, auth.sign_parts, auth.verify) == \
        (cephx.sign, cephx.sign_parts, cephx.verify)
    assert len(cephx.AuthHandshake.new_nonce()) == 16
