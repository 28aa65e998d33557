"""Checkpoint content digests, ported from
``bigdl_tpu/utils/ckpt_digest.py``: SHA-256 of each file's bytes,
recorded at save time in the ``ckptmeta.N.json`` marker and checked
before a restore loads anything, so a torn or changed file is refused
instead of loaded."""

from __future__ import annotations

import hashlib
from typing import Dict, List

from bigdl_tpu_torch.utils import file as File

__all__ = ["digest_bytes", "digest_file", "verify_digests"]

_CHUNK = 1 << 20


def digest_bytes(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def digest_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def verify_digests(root: str, digests: Dict[str, str]) -> List[str]:
    """The problems of the files under ``root`` against ``digests``
    (empty: verified).  Extra files are tolerated; missing or changed
    ones are not."""
    problems: List[str] = []
    for rel, want in sorted(digests.items()):
        p = File.join(root, rel)
        if not File.exists(p):
            problems.append(f"missing file {rel}")
            continue
        try:
            got = digest_file(p)
        except OSError as e:
            problems.append(f"unreadable file {rel} ({e})")
            continue
        if got != want:
            problems.append(f"digest mismatch on {rel} "
                            f"(want {want[:23]}…, got {got[:23]}…)")
    return problems
