"""The (R, 128) view shared by every packed buffer, and the launch plan of
the streaming sweeps.

Only the layout rule is shared with the reference: a buffer of ``n``
elements is viewed as ``padded_rows(n)`` rows of ``LANES`` fp32 values, so
packed buffers compare element for element across the two packages. How a
kernel tiles those rows is each Hopper kernel's own choice.

``plan`` sizes the streaming sweeps of ``csrc/quantize.cu`` (quantize,
dequantize: grid-stride in whole waves) and ``csrc/leaf.cu``
(correct_apply, outer_update: one trip, a CTA for every 256 units): a body
of 16-element units, then the elements after it one by one.
"""
from __future__ import annotations

from typing import Optional, Tuple

LANES = 128      # minor dim of every packed view (the reference's TPU lanes)
ROWS = 256       # buffers above this many rows are padded to ROW_ALIGN
ROW_ALIGN = 8
# the streaming sweeps: elements a lane takes per trip of the vector body,
# and threads per CTA (the sources' kUnit, kThreads)
UNIT = 16
THREADS = 256


def padded_rows(n: int) -> int:
    """Number of rows of the (R, LANES) view holding ``n`` elements."""
    r = max(1, -(-n // LANES))
    if r <= ROWS:
        return r
    return -(-r // ROW_ALIGN) * ROW_ALIGN


def aligned(*pairs) -> int:
    """1 if each (tensor, bytes) pointer is a multiple of its bytes: a
    streaming sweep's vector body may run."""
    return int(all(t.data_ptr() % b == 0 for t, b in pairs))


def plan(n: int, aligned: bool, wave: Optional[int] = None
         ) -> Tuple[int, int]:
    """(grid, units) of one streaming sweep over n elements. ``units``: the
    16-element units of the vector body, ``n // 16`` when every pointer is
    16-byte aligned, else 0. The body is a grid-stride walk: in trip t CTA
    b takes the units ``[(t * grid + b) * 256, ... + 256)``; the elements
    from ``16 * units`` on (all n when units = 0) then go one by one over
    every thread of the grid. ``grid``: the fewest CTAs that cover the work
    in the trips a grid of ``wave`` CTAs (one resident wave) would take,
    so that the trips are whole waves but for less than one CTA's units
    each; with no ``wave``, one trip: a CTA for every 256 units. At least
    1."""
    units = n // UNIT if aligned else 0
    work = -(-n // UNIT)
    trips = max(1, -(-work // (THREADS * wave))) if wave else 1
    return max(1, -(-work // (THREADS * trips))), units
