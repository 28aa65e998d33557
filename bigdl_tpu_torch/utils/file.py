"""Byte-blob persistence (``utils/File.scala:25``), ported from
``bigdl_tpu/utils/file.py`` for local paths (the JAX module's remote
``gs://`` paths through fsspec are not ported): atomic writes of opaque
bytes, and the directory helpers the checkpoint code uses.  Object
encoding belongs to ``utils/module_format.py``."""

from __future__ import annotations

import os
import tempfile

__all__ = ["save", "load", "makedirs", "listdir", "exists", "rename",
           "join"]


def _local(path: str) -> str:
    if "://" in path:
        raise ValueError(f"{path!r}: the port reads and writes local paths "
                         f"only")
    return path


def save(data: bytes, path: str, overwrite: bool = False):
    """(``File.save``): write through a temporary file in the same
    directory and rename it into place."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError(f"File.save moves bytes, got {type(data).__name__}; "
                        f"encode objects with utils.module_format first")
    if not overwrite and os.path.exists(_local(path)):
        raise FileExistsError(f"{path} exists and overwrite=False")
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str) -> bytes:
    with open(_local(path), "rb") as f:
        return f.read()


def makedirs(path: str):
    os.makedirs(_local(path), exist_ok=True)


def listdir(path: str):
    """Base names under a directory ([] when absent)."""
    return os.listdir(path) if os.path.isdir(_local(path)) else []


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def rename(src: str, dst: str):
    os.replace(_local(src), _local(dst))


def join(path: str, name: str) -> str:
    return os.path.join(_local(path), name)

