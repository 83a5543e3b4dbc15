"""Content hashes (the JAX package's ``aaclip_tpu/utils/hashing.py``)."""

import hashlib


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Full-content sha256 hex digest, streamed ``chunk`` bytes at a time."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(chunk), b""):
            h.update(piece)
    return h.hexdigest()
