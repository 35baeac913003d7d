"""ctypes bindings for the native host library (native/libzklaim_host.so).

Provides SHA256, ECDSA-Ed25519 and the context wire codec as native
code, mirroring the reference's native host layer (libgcrypt + OpenSSL;
reference zklaim/zklaim_hash.c, zklaim/zklaim_ecc.c).

The library is built from source (`make -C native`) at first use, when
it is missing or older than a source file (utils/build.py).  Every entry
point degrades gracefully: if the library cannot be built or loaded, callers fall back
to the pure-Python implementations -- behavior is identical, only speed
differs.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess

from .build import ROOT as _ROOT, build_if_stale

_LIB = None
_TRIED = False

_NATIVE = os.path.join(_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE, "libzklaim_host.so")


def build() -> bool:
    """Run `make -C native` if the library is missing or stale.  True if
    an up-to-date library exists afterwards."""
    sources = glob.glob(os.path.join(_NATIVE, "*.cpp")) + glob.glob(
        os.path.join(_NATIVE, "*.h")
    ) + [os.path.join(_NATIVE, "Makefile")]
    try:
        build_if_stale(_SO_PATH, sources, ["make", "-s", "-C", _NATIVE], 300)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def get_lib():
    """The loaded library, built first if needed; None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.zkn_sha256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p]
    lib.zkn_ecdsa_sign.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_char_p, u8p]
    lib.zkn_ecdsa_sign.restype = ctypes.c_int
    lib.zkn_ecdsa_verify.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_char_p, ctypes.c_char_p]
    lib.zkn_ecdsa_verify.restype = ctypes.c_int
    lib.zkn_ecdsa_pub.argtypes = [ctypes.c_char_p, u8p]
    lib.zkn_ecdsa_pub.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def sha256(data: bytes) -> bytes:
    lib = get_lib()
    out = (ctypes.c_uint8 * 32)()
    lib.zkn_sha256(data, len(data), out)
    return bytes(out)


def ecdsa_sign(msg: bytes, priv64: bytes, k32: bytes) -> bytes | None:
    lib = get_lib()
    sig = (ctypes.c_uint8 * 64)()
    if lib.zkn_ecdsa_sign(msg, len(msg), priv64, k32, sig):
        return None
    return bytes(sig)


def ecdsa_verify(msg: bytes, sig64: bytes, pub32: bytes) -> bool:
    lib = get_lib()
    return lib.zkn_ecdsa_verify(msg, len(msg), sig64, pub32) == 0


def ecdsa_pub(priv64: bytes) -> bytes:
    lib = get_lib()
    out = (ctypes.c_uint8 * 32)()
    lib.zkn_ecdsa_pub(priv64, out)
    return bytes(out)
