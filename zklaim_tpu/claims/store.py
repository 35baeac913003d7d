"""Durable on-disk artifacts: keys, contexts, fixed-base tables.

The reference realizes checkpoint/resume as full serialization -- pk/vk
stream export/import and the context wire format; main.c:126-138
sketches writing vk/pk to disk so issuer/prover/verifier can be separate
processes (SURVEY.md §5 "Checkpoint / resume").  This module is that
capability of this framework: atomic save/load of the serde byte
formats, so keys generated on one host are loadable on any other
(arrays are rebuilt on whatever devices the loader has).
"""

from __future__ import annotations

import os
import tempfile

from . import serde
from .api import Context


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".zklaim-tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_proving_key(path: str, pk_bytes: bytes) -> None:
    _atomic_write(path, pk_bytes)


def load_proving_key(path: str) -> bytes:
    raw = open(path, "rb").read()
    if raw[:4] != serde.MAGIC_PK:
        raise serde.SerdeError(f"{path}: not a zklaim proving key")
    return raw


def save_verifying_key(path: str, vk_bytes: bytes) -> None:
    _atomic_write(path, vk_bytes)


def load_verifying_key(path: str) -> bytes:
    raw = open(path, "rb").read()
    if raw[:4] != serde.MAGIC_VK:
        raise serde.SerdeError(f"{path}: not a zklaim verifying key")
    return raw


def save_context(path: str, ctx: Context) -> None:
    _atomic_write(path, ctx.serialize())


def load_context(path: str) -> Context:
    ctx, status = Context.deserialize(open(path, "rb").read())
    if ctx is None:
        raise ValueError(f"{path}: corrupt context (status {status})")
    return ctx


def save_issuer_state(dirpath: str, ctx: Context) -> None:
    """Issuer checkpoint: context + both keys (main.c:126-138 equivalent)."""
    save_context(os.path.join(dirpath, "ctx.zkl"), ctx)
    save_proving_key(os.path.join(dirpath, "pk.zkl"), ctx.pk)
    save_verifying_key(os.path.join(dirpath, "vk.zkl"), ctx.vk)


def load_issuer_state(dirpath: str) -> Context:
    ctx = load_context(os.path.join(dirpath, "ctx.zkl"))
    ctx.pk = load_proving_key(os.path.join(dirpath, "pk.zkl"))
    ctx.vk = load_verifying_key(os.path.join(dirpath, "vk.zkl"))
    return ctx
