"""The two names the copied scheduler needs from the KV-cache tier code.

Copies of ``KVPoolError`` (``repro/core/kvcache/pool.py``) and
``payload_nbytes`` (``repro/core/kvcache/tiers.py``).  The distributed
pool, the host and SSD tiers and their compressed wire payloads are not
part of the port yet, so ``payload_nbytes`` here only knows raw
``(k, v)`` array tuples.
"""
from __future__ import annotations

from typing import Any


class KVPoolError(RuntimeError):
    """Pool unreachable — network partition or cache-node loss.  Raised
    by ``fetch``/``publish`` while a partition window is active; callers
    (the scheduler's pool walk) must degrade to recompute, never crash."""


def payload_nbytes(payload: Any, default: int = 0) -> int:
    """Best-effort wire size of a page payload: (k, v) array tuples know
    their bytes; opaque payloads (the simulator's ``True``) fall back to
    ``default``."""
    if isinstance(payload, tuple):
        n = sum(int(getattr(p, "nbytes", 0)) for p in payload)
        if n:
            return n
    return int(default)
