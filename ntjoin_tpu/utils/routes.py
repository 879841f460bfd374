"""Counted host routes of the device path.

A device run takes the host path for a piece of work only where a
capacity limit of the device code is known before any device work starts
(int32 positions, the 32-assembly support mask, 4-bit support counts,
weights that float32 cannot hold exactly).  Each such route is counted
here and reported on stderr with its reason; any other device failure is
an error, never a silent host run.
"""
from __future__ import annotations

import sys

_count = 0


def host_route(reason: str) -> None:
    """Record one capacity route to the host path and say why."""
    global _count
    _count += 1
    print(f"ntjoin: host route: {reason}", file=sys.stderr, flush=True)


def host_routes() -> int:
    """Host routes taken in this process since the last :func:`reset`."""
    return _count


def reset() -> None:
    global _count
    _count = 0
