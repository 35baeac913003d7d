"""Native host library vs Python implementations and reference fixtures."""

import hashlib
import random

import pytest

from zklaim_tpu.claims import signing as S
from zklaim_tpu.utils import native

import os


@pytest.fixture(autouse=True)
def _library():
    """The library builds from source at first use; the tests need it."""
    assert native.available(), "native library failed to build (make -C native)"

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("n", [0, 1, 47, 48, 55, 56, 63, 64, 65, 1000])
def test_native_sha256_matches_hashlib(rng, n):
    data = bytes(rng.randrange(256) for _ in range(n))
    assert native.sha256(data) == hashlib.sha256(data).digest()


def test_native_verify_reference_fixture():
    priv = open(f"{FIX}/ed25519_priv", "rb").read()
    pub = open(f"{FIX}/ed25519_pub", "rb").read()
    sig = open(f"{FIX}/randfile_sig", "rb").read()
    msg = open(f"{FIX}/randfile", "rb").read()[:1024]
    assert native.ecdsa_verify(msg, sig, pub)
    assert not native.ecdsa_verify(msg + b"x", sig, pub)
    assert native.ecdsa_pub(priv) == pub


def test_native_sign_crosscheck_python(rng):
    priv = S.keygen(random.Random(4))
    pub = S.pk_to_pub(priv)
    msg = b"native interop message"
    k = rng.randrange(1, S.L).to_bytes(32, "big")
    sig_native = native.ecdsa_sign(msg, priv, k)
    assert sig_native is not None
    # native-signed verifies in Python, and vice versa
    assert S.verify(msg, sig_native, pub)
    sig_py = S.sign(msg, priv, random.Random(9))
    assert native.ecdsa_verify(msg, sig_py, pub)
    # same nonce -> identical signature bytes (same math end to end)
    class FixedK:
        def randrange(self, a, b=None):
            return int.from_bytes(k, "big")
    assert S.sign(msg, priv, FixedK()) == sig_native
