"""Contig orientation from minimizer position trends.

Reference semantics (``ntjoin_assemble.py:30-50``): strict monotonicity wins;
otherwise either the Mann-Kendall trend test (``--mkt``) or a >= m% monotone
pair vote decides; '?' when undecidable.

The Mann-Kendall implementation reproduces ``pymannkendall.original_test``
numerics (S statistic, tie-corrected variance, z, two-sided p) without the
dependency; a vectorized JAX variant for batch orientation lives in
``ops/mannkendall.py``.
"""
from __future__ import annotations

import math
from typing import Sequence


def _norm_sf(x: float) -> float:
    """1 - Phi(x) via erfc (matches scipy's cephes ndtr to double precision)."""
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def mann_kendall(positions: Sequence[int], alpha: float = 0.05):
    """Return (trend, h, p, z) of the MK original test."""
    n = len(positions)
    if n > 128:
        # exact vectorized S / tie terms for long runs: the pairwise sign
        # sum and tie counts are pure-integer, so blocked NumPy reproduces
        # the loop bit-for-bit at ~100x the speed (the reference flags
        # --mkt as "computationally-intensive"; this keeps it usable on
        # long contig runs).  Block rows so live memory stays ~32 MB.
        import numpy as np

        x = np.asarray(positions, dtype=np.int64)
        idx = np.arange(n)
        s = 0
        blk = max(1, (1 << 22) // n)
        for i0 in range(0, n - 1, blk):
            i1 = min(i0 + blk, n - 1)
            d = x[None, :] - x[i0:i1, None]  # (b, n) = x_j - x_i
            after = idx[None, :] > idx[i0:i1, None]  # j > i
            s += int(np.sum(np.sign(d), where=after, dtype=np.int64))
        _, t = np.unique(x, return_counts=True)
        tie_term = int(np.sum(t * (t - 1) * (2 * t + 5)))
    else:
        s = 0
        for i in range(n - 1):
            for j in range(i + 1, n):
                d = positions[j] - positions[i]
                s += (d > 0) - (d < 0)
        # tie correction
        counts: dict[int, int] = {}
        for x in positions:
            counts[x] = counts.get(x, 0) + 1
        tie_term = sum(t * (t - 1) * (2 * t + 5) for t in counts.values())
    var_s = (n * (n - 1) * (2 * n + 5) - tie_term) / 18.0
    if s > 0:
        z = (s - 1) / math.sqrt(var_s)
    elif s < 0:
        z = (s + 1) / math.sqrt(var_s)
    else:
        z = 0.0
    p = 2.0 * _norm_sf(abs(z))
    # pymannkendall: h = |z| > Phi^-1(1 - alpha/2); equivalent two-sided test
    h = p < alpha and z != 0.0
    if h and z > 0:
        trend = "increasing"
    elif h and z < 0:
        trend = "decreasing"
    else:
        trend = "no trend"
    return trend, h, p, z


def _mk_finish(s: int, positions: Sequence[int], alpha: float = 0.05):
    """Host float64 tail of the MK test from an exact integer S: tie
    correction, variance, z, two-sided p — identical numerics to
    ``mann_kendall`` (pymannkendall original_test)."""
    import numpy as np

    n = len(positions)
    _, t = np.unique(np.asarray(positions, dtype=np.int64), return_counts=True)
    tie_term = int(np.sum(t * (t - 1) * (2 * t + 5)))
    var_s = (n * (n - 1) * (2 * n + 5) - tie_term) / 18.0
    if s > 0:
        z = (s - 1) / math.sqrt(var_s)
    elif s < 0:
        z = (s + 1) / math.sqrt(var_s)
    else:
        z = 0.0
    p = 2.0 * _norm_sf(abs(z))
    h = p < alpha and z != 0.0
    if h and z > 0:
        trend = "increasing"
    elif h and z < 0:
        trend = "decreasing"
    else:
        trend = "no trend"
    return trend, h, p, z


def _mk_orient(trend: str, h: bool, p: float) -> str:
    if h and p <= 0.05:
        return "+" if trend == "increasing" else "-"
    return "?"


def determine_orientation(
    positions: Sequence[int], use_mkt: bool, m_percent: float
) -> str:
    """'+', '-' or '?' for a run of target minimizer positions."""
    if len(positions) <= 1:
        return "?"
    inc = all(x < y for x, y in zip(positions, positions[1:]))
    if inc:
        return "+"
    dec = all(x > y for x, y in zip(positions, positions[1:]))
    if dec:
        return "-"
    if use_mkt:
        trend, h, p, _ = mann_kendall(positions)
        return _mk_orient(trend, h, p)
    up = sum(1 for x, y in zip(positions, positions[1:]) if x < y)
    positive_perc = up / float(len(positions) - 1) * 100.0
    if positive_perc >= m_percent:
        return "+"
    if 100.0 - positive_perc >= m_percent:
        return "-"
    return "?"


def determine_orientations(
    runs: Sequence[Sequence[int]], use_mkt: bool, m_percent: float
) -> list[str]:
    """Orientations for a batch of position runs (one path's contig runs).

    Identical verdicts to per-run ``determine_orientation``; with
    ``use_mkt`` the ambiguous (non-monotonic) runs are batched into ONE
    device Mann-Kendall S computation (``ops.mannkendall.mk_s_batch``,
    integer-exact) with the float64 tail finished on host — bit-identical
    p/z to the scalar path.  Runs past the int32-exact S bound (or with
    positions past int32) take the scalar per-run MK.
    """
    out = [""] * len(runs)
    ambiguous: list[int] = []
    for i, positions in enumerate(runs):
        if len(positions) <= 1:
            out[i] = "?"
        elif all(x < y for x, y in zip(positions, positions[1:])):
            out[i] = "+"
        elif all(x > y for x, y in zip(positions, positions[1:])):
            out[i] = "-"
        else:
            ambiguous.append(i)
    if not ambiguous:
        return out
    if not use_mkt:
        for i in ambiguous:
            out[i] = determine_orientation(runs[i], use_mkt, m_percent)
        return out

    max_len = max(len(runs[i]) for i in ambiguous)
    s_vals = None
    if (
        len(ambiguous) >= 2
        and max_len <= 65536
        and max(max(runs[i]) for i in ambiguous) < 2**31  # int32 positions
    ):
        import jax.numpy as jnp
        import numpy as np

        from ntjoin_tpu.ops.mannkendall import mk_s_batch

        pad = 8
        while pad < max_len:
            pad *= 2
        pos = np.zeros((len(ambiguous), pad), np.int32)
        lengths = np.zeros(len(ambiguous), np.int32)
        for j, i in enumerate(ambiguous):
            pos[j, : len(runs[i])] = runs[i]
            lengths[j] = len(runs[i])
        s_vals = np.asarray(mk_s_batch(jnp.asarray(pos), jnp.asarray(lengths)))
    for j, i in enumerate(ambiguous):
        if s_vals is not None:
            trend, h, p, _ = _mk_finish(int(s_vals[j]), runs[i])
        else:
            trend, h, p, _ = mann_kendall(runs[i])
        out[i] = _mk_orient(trend, h, p)
    return out
