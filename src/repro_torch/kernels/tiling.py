"""The (R, 128) view shared by every packed buffer.

Only the layout rule is shared with the reference: a buffer of ``n``
elements is viewed as ``padded_rows(n)`` rows of ``LANES`` fp32 values, so
packed buffers compare element for element across the two packages. How a
kernel tiles those rows is each Hopper kernel's own choice.
"""
from __future__ import annotations

LANES = 128      # minor dim of every packed view (the reference's TPU lanes)
ROWS = 256       # buffers above this many rows are padded to ROW_ALIGN
ROW_ALIGN = 8


def padded_rows(n: int) -> int:
    """Number of rows of the (R, LANES) view holding ``n`` elements."""
    r = max(1, -(-n // LANES))
    if r <= ROWS:
        return r
    return -(-r // ROW_ALIGN) * ROW_ALIGN
