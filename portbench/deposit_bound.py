"""The least time of a census's segment deposit on one card.

The work is what the algorithm needs, counted from the census's own facet
count, whatever implements the deposit: one cell visit a facet at
roofline.FLOPS_FACET float operations over the float peak of the state's
type, or the tally's cells written once over the bandwidth, whichever is
larger.  Nothing here counts segment rows, pieces, tiles or re-runs.
"""

from __future__ import annotations

from .roofline import FLOPS_FACET, PEAK_BYTES, PEAK_FLOPS, TALLY_BYTES


def deposit_seconds(facets: int, ncells: int, dtype: str,
                    tally_dtype: str) -> float:
    """Least seconds of one census's deposit of `facets` cell visits into a
    tally of `ncells` cells."""
    return max(facets * FLOPS_FACET / PEAK_FLOPS[dtype],
               ncells * TALLY_BYTES[tally_dtype] / PEAK_BYTES)


def deposit_roofline(solves: list, ncells: int, dtype: str,
                     tally_dtype: str) -> float | None:
    """The least time of the solves' censuses that deposited (a "raster"
    phase) over their deposits' device time, in %; None where none did."""
    steps = [st for s in solves for st in s["steps"]
             if "raster" in st["phases"]]
    busy = sum(st["phases"]["raster"] for st in steps)
    if busy <= 0:
        return None
    least = sum(deposit_seconds(st["facets"], ncells, dtype, tally_dtype)
                for st in steps)
    return 100.0 * least / busy
