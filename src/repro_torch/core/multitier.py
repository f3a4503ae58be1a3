"""Bucket ladder of the survivor-compacted runtime (counterpart of
``repro.core.multitier.bucket_ladder`` / ``bucket_for``)."""

from __future__ import annotations

__all__ = ["bucket_ladder", "bucket_for"]


def bucket_ladder(batch: int) -> tuple[int, ...]:
    """Sub-batch widths survivors are padded to: powers of two below
    ``batch``, plus ``batch`` itself (a no-exit step compacts through the
    identity permutation at full width)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    out = []
    b = 1
    while b < batch:
        out.append(b)
        b *= 2
    out.append(batch)
    return tuple(out)


def bucket_for(n: int, batch: int) -> int:
    """Smallest ladder bucket that fits ``n`` survivors (min 1: even an
    all-exit step keeps one padding row downstream so per-layer cache
    write indices stay in lockstep across tiers)."""
    for b in bucket_ladder(batch):
        if b >= max(int(n), 1):
            return b
    return batch
