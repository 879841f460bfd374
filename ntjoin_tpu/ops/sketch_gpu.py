"""GPU minimizer sketch: rolling ntHash2 and sliding-window argmin as two
Pallas kernels (Triton route), with emission compaction in plain XLA.

Layout.  A batch of records is packed into one flat code array, each
record followed by at least k-1 invalid bases so that no k-mer spans two
records.  The flat k-mer stream is cut into C chunks of L = _BLOCKS * w
k-mer starts, one chunk per kernel lane.  Lane c reads bases c*L + r for
r in [0, R), R >= L + w + k - 1, so every window the lane owns is computed
from its own bases; the (w + k - 1)-base halo is read again by lane c+1.
A program handles _LANES adjacent lanes, so each row of the (R, C) output
layout is one coalesced store.

Kernels.
* ``_hash_kernel`` runs the ntHash2 recurrence down each lane with the
  state in registers, and writes the canonical hash (lo, hi words) and a
  validity flag of the k-mer ending at every row.
* ``_window_kernel`` computes each lane's sliding-window argmin by the
  van Herk / Gil-Werman scheme: suffix minima of each block of w k-mers go
  to a scratch column in device memory, prefix minima of the next block
  stay in registers, and window t is the smaller of the two (ties to the
  left, like btllib).  It sets ``mark[p] = 1`` at the argmin p of every
  window whose w k-mers are all valid.  Argmin positions never decrease as
  the window slides, so btllib's "emit when the argmin moves" rule emits
  each distinct argmin once, in position order: the sketch is exactly the
  set of marked positions.

XLA then compacts the marks (``jnp.nonzero`` under a static cap, raised
and re-run when a repeat-dense batch overflows it) and gathers the winning
hashes.  Records with interior N runs are split into clean segments that
ride the batches as pseudo-records, and the windows spanning their
junctions are sketched on the host (``_patch_emissions``).  Bit parity
with the NumPy oracle is enforced by ``tests/test_sketch_gpu.py`` (kernels
in interpret mode) and on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ntjoin_tpu.constants import CODE_INVALID, SEEDS, srol_n
from ntjoin_tpu.ops import u64
from ntjoin_tpu.ops.nthash_np import (
    Sketch,
    _window_lexmin,
    canonical_hashes,
    derive_hash,
)
from ntjoin_tpu.utils.routes import host_route

_U32 = jnp.uint32
_I32 = jnp.int32
_MAXU = np.uint32(0xFFFFFFFF)

_LANES = 32  # chunk lanes per program: one warp, one lane per thread
_BLOCKS = 8  # window blocks of w k-mers per lane: L = _BLOCKS * w
_UNROLL = 8  # rows per loop iteration, their loads issued ahead of the chain
_COMPILER = plgpu.CompilerParams(num_warps=1, num_stages=1)

# Device positions are int32.  The margin covers what the layout adds past
# a batch's last base (halo rows and lane-count padding).
_I32_CAP = (1 << 31) - (1 << 22)
# Bases per device program: a few GB of intermediates (~25 B per base).
# Longer clean stretches are cut into overlapping pieces.
_BATCH_BASES = 1 << 28
# Junction windows are host work; a record whose junction work passes
# this (or a fifth of its length) is sketched whole by ops/sketch_jax.
_PATCH_WORK_MIN = 1 << 20

_EMPTY = Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


# -- kernels -----------------------------------------------------------------


def _split64(v: int) -> tuple[np.uint32, np.uint32]:
    return np.uint32(v & 0xFFFFFFFF), np.uint32((v >> 32) & 0xFFFFFFFF)


def _tables(k: int):
    """The four 4-entry seed tables of the two recurrences.

    The reverse-strand outgoing table is pre-rotated by srol^-1: rotation
    distributes over xor (it is a bit permutation), so
    ``sror1(r ^ seed[rc(out)]) = sror1(r) ^ sror1(seed)[out]``, and both
    recurrences become ``state = rot1(state) ^ m`` with ``m`` independent
    of the carried state.
    """
    seed_in = [_split64(SEEDS[c]) for c in range(4)]
    seed_out = [_split64(srol_n(SEEDS[c], k)) for c in range(4)]
    seed_rc_out_rot = [
        _split64(srol_n(SEEDS[3 - c], 33 * 31 - 1)) for c in range(4)
    ]
    seed_rc_in = [_split64(srol_n(SEEDS[3 - c], k - 1)) for c in range(4)]
    return seed_in, seed_out, seed_rc_out_rot, seed_rc_in


def _sel(code, tab):
    """4-way constant select by base code; invalid codes select 0."""
    zero = _U32(0)

    def word(i):
        return jnp.where(
            code == 0, tab[0][i],
            jnp.where(code == 1, tab[1][i],
                      jnp.where(code == 2, tab[2][i],
                                jnp.where(code == 3, tab[3][i], zero))),
        )

    return word(0), word(1)


def _rows(n: int, load, step, carry):
    """``carry = step(i, load(i), carry)`` for i in range(n).

    _UNROLL rows per loop iteration: their loads do not depend on the
    carry, so all of them are issued before the dependent chain runs.
    """
    def body(it, carry):
        i0 = it * _UNROLL
        data = [load(i0 + u) for u in range(_UNROLL)]
        for u in range(_UNROLL):
            carry = step(i0 + u, data[u], carry)
        return carry

    carry = jax.lax.fori_loop(0, n // _UNROLL, body, carry)
    for i in range(n // _UNROLL * _UNROLL, n):
        carry = step(i, load(i), carry)
    return carry


def _hash_kernel(x_ref, lo_ref, hi_ref, val_ref, *, k: int, L: int, R: int):
    """Rolling ntHash2 down each lane: row r of the outputs is the
    canonical hash of the k-mer ending at base c*L + r, and its validity
    (no invalid base among its k).  Rows r < k-1 hold partial k-mers and
    are never valid."""
    t_in, t_out, t_rc_out, t_rc_in = _tables(k)
    c0 = pl.program_id(0) * _LANES
    lanes = pl.ds(c0, _LANES)
    base = (c0 + jax.lax.iota(_I32, _LANES)) * L

    def load(r):
        x = x_ref[base + r].astype(_I32)
        # outgoing base of the recurrence; the state starts empty at row 0
        lag = x_ref[base + jnp.maximum(r - k, 0)].astype(_I32)
        return x, jnp.where(r >= k, lag, CODE_INVALID)

    def step(r, data, carry):
        x, lag = data
        f, rv, last_bad = carry
        # fwd_r = srol(fwd) ^ srol^k(seed[out]) ^ seed[in]
        f = u64.xor(u64.srol1(f), u64.xor(_sel(lag, t_out), _sel(x, t_in)))
        # rev_r = sror(rev) ^ sror(seed[rc(out)]) ^ srol^(k-1)(seed[rc(in)])
        rv = u64.xor(
            u64.sror1(rv), u64.xor(_sel(lag, t_rc_out), _sel(x, t_rc_in))
        )
        last_bad = jnp.where(x >= CODE_INVALID, r, last_bad)
        lo, hi = u64.add(f, rv)
        lo_ref[r, lanes] = lo
        hi_ref[r, lanes] = hi
        val_ref[r, lanes] = (r - last_bad >= k).astype(jnp.int8)
        return f, rv, last_bad

    zero = jnp.zeros(_LANES, _U32)
    _rows(R, load, step,
          ((zero, zero), (zero, zero), jnp.full(_LANES, -1, _I32)))


def _window_kernel(lo_ref, hi_ref, val_ref, _mark_in, mark_ref,
                   s_lo, s_hi, s_ix, *, k: int, w: int, L: int, C: int):
    """Mark the argmin of every window of w valid k-mers a lane owns.

    Window t of a lane covers its k-mers [t, t + w - 1] (k-mer j sits at
    hash row j + k - 1).  With blocks of w k-mers, window t = b*w + i is
    the suffix [t, (b+1)*w) of block b and the prefix [(b+1)*w, t + w) of
    block b+1: one backward pass per block stores the suffix minima in the
    scratch column, one forward pass over the next block carries the
    prefix minimum and emits the block's windows.
    """
    c0 = pl.program_id(0) * _LANES
    lanes = pl.ds(c0, _LANES)
    col = c0 + jax.lax.iota(_I32, _LANES)
    base = col * L
    dummy = C * L + col  # one spare mark per lane for masked-off stores
    ones = jnp.ones(_LANES, jnp.int8)
    maxu = jnp.full(_LANES, _MAXU, _U32)
    zero = jnp.zeros(_LANES, _I32)

    def kmer(j):
        r = j + (k - 1)
        return lo_ref[r, lanes], hi_ref[r, lanes], val_ref[r, lanes]

    def suffix_pass(b, last_bad):
        """Suffix minima of block b into scratch row i (ties to the left);
        also folds the block's invalid k-mers into ``last_bad``."""
        def load(i2):
            return kmer(b * w + (w - 1 - i2))

        def step(i2, data, carry):
            h_lo, h_hi, valid = data
            m_lo, m_hi, m_ix, last_bad = carry
            i = w - 1 - i2
            j = b * w + i
            take = u64.less_eq((h_lo, h_hi), (m_lo, m_hi))
            m_lo = jnp.where(take, h_lo, m_lo)
            m_hi = jnp.where(take, h_hi, m_hi)
            m_ix = jnp.where(take, j, m_ix)
            s_lo[i, lanes] = m_lo
            s_hi[i, lanes] = m_hi
            s_ix[i, lanes] = m_ix
            last_bad = jnp.maximum(last_bad, jnp.where(valid == 0, j, -1))
            return m_lo, m_hi, m_ix, last_bad

        return _rows(w, load, step, (maxu, maxu, zero, last_bad))[3]

    def block(b, carry):
        """Windows of block b, read against the prefix of block b+1."""
        last_bad, last = carry

        def load(i):
            return kmer((b + 1) * w + i) + (
                s_lo[i, lanes], s_hi[i, lanes], s_ix[i, lanes]
            )

        def step(i, data, carry):
            h_lo, h_hi, valid, m_lo, m_hi, m_ix = data
            p_lo, p_hi, p_ix, last_bad, last = carry
            # window t = b*w + i ends at k-mer e - 1, every k-mer before e
            # is folded into last_bad
            t = b * w + i
            e = t + w
            take_s = u64.less_eq((m_lo, m_hi), (p_lo, p_hi))
            a = jnp.where(take_s, m_ix, p_ix)
            alive = last_bad < t
            emit = alive & (a != last)
            plgpu.store(
                mark_ref.at[jnp.where(emit, base + a, dummy)], ones, mask=emit
            )
            last = jnp.where(alive, a, last)
            take_e = u64.less((h_lo, h_hi), (p_lo, p_hi))
            p_lo = jnp.where(take_e, h_lo, p_lo)
            p_hi = jnp.where(take_e, h_hi, p_hi)
            p_ix = jnp.where(take_e, e, p_ix)
            last_bad = jnp.where(valid == 0, e, last_bad)
            return p_lo, p_hi, p_ix, last_bad, last

        out = _rows(w, load, step, (maxu, maxu, zero, last_bad, last))
        last_bad, last = out[3], out[4]
        suffix_pass(b + 1, last_bad)
        return last_bad, last

    last_bad = suffix_pass(0, jnp.full(_LANES, -1, _I32))
    jax.lax.fori_loop(
        0, L // w, block, (last_bad, jnp.full(_LANES, -1, _I32))
    )


# -- device program ----------------------------------------------------------


class _Layout(NamedTuple):
    L: int  # k-mer starts owned by a lane
    C: int  # lanes
    R: int  # bases (rows) read by a lane
    buflen: int  # flat code buffer length


def _lanes_for(chunks: int) -> int:
    """Lane count for ``chunks`` chunks: a multiple of _LANES on a grid of
    eight steps per octave, so batches of similar size share compiled
    programs at the cost of at most 1/8 padding.  (Powers of two shared no
    more programs on the measured jobs and padded a 2^27-base record
    almost 2x.)"""
    chunks = max(chunks, _LANES)
    step = max(_LANES, 1 << max(chunks.bit_length() - 4, 0))
    return _ceil_to(chunks, step)


def _layout(n_bases: int, k: int, w: int) -> _Layout:
    L = _BLOCKS * w
    C = _lanes_for(-(-max(n_bases - k + 1, 1) // L))
    R = _ceil_to(L + w + k - 1, _UNROLL)
    return _Layout(L, C, R, (C - 1) * L + R)


def _cap_for(lay: _Layout, w: int) -> int:
    """Emission cap of a layout: random sequence emits ~2 per w + 1
    k-mers, so 2.5 per w leaves a margin; denser input re-runs."""
    return max(5 * (lay.C * lay.L // w + 1) // 2, 4096)


@jax.jit
def _prep_codes(packed, starts, ends):
    """2-bit packed upload -> int8 code buffer, painted on device.

    2-bit codes cannot hold invalid bases, so the invalid runs (record
    separators, N runs, the buffer tail) ride along as (start, end) lists
    and are painted with one diff-scatter and a cumsum.  ``starts`` and
    ``ends`` are padded with the sentinel ``4*len(packed)``, which the
    scatter drops.
    """
    shifts = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    codes = (
        (packed[:, None] >> shifts[None, :]) & jnp.uint8(3)
    ).astype(jnp.int8).reshape(-1)
    m = codes.shape[0]
    idx = jnp.concatenate([starts, ends])
    upd = jnp.concatenate([jnp.ones_like(starts), jnp.full_like(ends, -1)])
    delta = jnp.zeros(m, _I32).at[idx].add(upd, mode="drop")
    inside = jnp.cumsum(delta) > 0
    return jnp.where(inside, jnp.int8(CODE_INVALID), codes)


def _hash(codes, k: int, lay: _Layout, interpret: bool):
    rows = jax.ShapeDtypeStruct((lay.R, lay.C), _U32)
    return pl.pallas_call(
        functools.partial(_hash_kernel, k=k, L=lay.L, R=lay.R),
        out_shape=(rows, rows, jax.ShapeDtypeStruct((lay.R, lay.C), jnp.int8)),
        grid=(lay.C // _LANES,),
        compiler_params=_COMPILER,
        interpret=interpret,
        name="ntjoin_hash",
    )(codes)


def _window(lo, hi, val, k: int, w: int, lay: _Layout, interpret: bool):
    scratch = jax.ShapeDtypeStruct((w, lay.C), _U32)
    marks = jnp.zeros(lay.C * lay.L + lay.C, jnp.int8)
    out = pl.pallas_call(
        functools.partial(_window_kernel, k=k, w=w, L=lay.L, C=lay.C),
        out_shape=(
            jax.ShapeDtypeStruct(marks.shape, jnp.int8),
            scratch, scratch, jax.ShapeDtypeStruct((w, lay.C), _I32),
        ),
        grid=(lay.C // _LANES,),
        input_output_aliases={3: 0},
        compiler_params=_COMPILER,
        interpret=interpret,
        name="ntjoin_window",
    )(lo, hi, val, marks)
    return out[0][: lay.C * lay.L]


@functools.partial(
    jax.jit, static_argnames=("k", "w", "lay", "cap", "interpret")
)
def _sketch_batch(packed, starts, ends, *, k: int, w: int, lay: _Layout,
                  cap: int, interpret: bool):
    """One batch on device: unpack -> hash -> window marks -> compaction.

    Returns (pos, lo, hi, count): the first ``min(count, cap)`` entries
    are the marked k-mer starts in ascending batch position and their
    canonical hash words.
    """
    codes = _prep_codes(packed, starts, ends)
    lo, hi, val = _hash(codes, k, lay, interpret)
    mark = _window(lo, hi, val, k, w, lay, interpret)
    count = jnp.sum(mark, dtype=_I32)
    (pos,) = jnp.nonzero(mark, size=cap, fill_value=0)
    pos = pos.astype(_I32)
    row = pos % lay.L + (k - 1)
    col = pos // lay.L
    return pos, lo[row, col], hi[row, col], count


# -- host orchestration ------------------------------------------------------


def _pack2_host(codes: np.ndarray, out: np.ndarray, byte_off: int) -> None:
    """Pack codes (0..3; invalid bits ignored) into ``out`` from byte
    ``byte_off`` on.  Uses the C++ packer when available."""
    from ntjoin_tpu.io.native import available, pack2_native

    if available() and pack2_native(codes, out, byte_off):
        return
    n = codes.shape[0]
    nfull = n // 4
    c = (codes[: nfull * 4].astype(np.uint8) & 3).reshape(-1, 4)
    out[byte_off : byte_off + nfull] = (
        c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    )
    if n % 4:
        tail = np.uint8(0)
        for j in range(n % 4):
            tail |= np.uint8((int(codes[nfull * 4 + j]) & 3) << (2 * j))
        out[byte_off + nfull] = tail


def _invalid_runs(codes: np.ndarray, base: int) -> list[tuple[int, int]]:
    """(start, end) runs of invalid bases in ``codes``, offset by ``base``."""
    inv = np.asarray(codes) >= CODE_INVALID
    if not inv.any():
        return []
    d = np.diff(inv.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if inv[0]:
        starts = np.concatenate([[0], starts])
    if inv[-1]:
        ends = np.concatenate([ends, [inv.shape[0]]])
    return [(base + int(s), base + int(e)) for s, e in zip(starts, ends)]


def _host_sketch(codes: np.ndarray, k: int, w: int) -> Sketch:
    from ntjoin_tpu.io.native import available, sketch_codes_native

    if available():
        return sketch_codes_native(codes, k, w)
    from ntjoin_tpu.ops.nthash_np import sketch_codes

    return sketch_codes(codes, k, w)


# -- segmented sketch of N-containing records --------------------------------
#
# The sketch is the set of distinct window argmins.  For a record with
# interior N runs the windows split into (a) windows fully inside one
# maximal clean segment, sketched on device with the segments as
# pseudo-records, and (b) windows spanning segment junctions (at most
# ~2(w-1) per junction), sketched on the host from the junction
# neighbourhoods' hashes.  The union, merged by position, is the exact
# sketch.


def _segments_of(n: int, runs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Maximal valid-base intervals = complement of the invalid runs."""
    segs = []
    prev = 0
    for s, e in runs:
        if s > prev:
            segs.append((prev, s))
        prev = e
    if prev < n:
        segs.append((prev, n))
    return segs


def _patch_plan(n: int, runs: list[tuple[int, int]], k: int, w: int):
    """(segments, k-mers per segment, stream offsets, patch intervals, work).

    Stream rank space = valid k-mers in order; a window is device-covered
    iff it lies fully inside one long (>= w+k-1 bases) segment; the patch
    intervals are the complement within [0, N_s - w].
    """
    segs = _segments_of(n, runs)
    nks = [max(0, (e - s) - k + 1) for s, e in segs]
    offs = np.concatenate([[0], np.cumsum(nks)]).astype(np.int64)
    n_stream = int(offs[-1])
    if n_stream < w:
        return segs, nks, offs, [], 0
    inside = [
        (int(offs[i]), int(offs[i]) + nks[i] - w)
        for i, (s, e) in enumerate(segs)
        if (e - s) >= (w + k - 1)
    ]
    patch_ivs = []
    cur = 0
    for a, b in inside:  # disjoint, ascending
        if a > cur:
            patch_ivs.append((cur, a - 1))
        cur = max(cur, b + 1)
    if cur <= n_stream - w:
        patch_ivs.append((cur, n_stream - w))
    work = sum(b - a + w for a, b in patch_ivs)
    return segs, nks, offs, patch_ivs, work


def _stream_slice(codes, k, segs, nks, offs, lo: int, hi: int):
    """Canonical hashes + genomic positions of stream ranks [lo, hi]."""
    hs, ps = [], []
    for i, (s, _e) in enumerate(segs):
        if nks[i] == 0:
            continue
        a = max(lo, int(offs[i]))
        b = min(hi, int(offs[i]) + nks[i] - 1)
        if a > b:
            continue
        la = a - int(offs[i])
        sl = np.asarray(codes[s + la : s + (b - int(offs[i])) + k])
        canon, _ = canonical_hashes(sl, k)
        hs.append(canon)
        ps.append(np.arange(s + la, s + la + canon.shape[0], dtype=np.int64))
    if not hs:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    return np.concatenate(hs), np.concatenate(ps)


def _patch_emissions(codes, k: int, w: int, segs, nks, offs, patch_ivs):
    """Distinct argmins (positions, canonical hashes) of the patch windows."""
    out_pos, out_canon = [], []
    for a, b in patch_ivs:
        h, pos = _stream_slice(codes, k, segs, nks, offs, a, b + w - 1)
        arg = np.unique(_window_lexmin(h, w))
        out_pos.append(pos[arg])
        out_canon.append(h[arg])
    if not out_pos:
        return np.empty(0, np.int64), np.empty(0, np.uint64)
    return np.concatenate(out_pos), np.concatenate(out_canon)


def _pieces(s: int, e: int, k: int, w: int) -> list[tuple[int, int]]:
    """Clean interval [s, e) as pieces of at most _BATCH_BASES bases that
    overlap by w + k - 2, so every window lies inside one of them."""
    span = _BATCH_BASES - (w + k - 2)
    return [(a, min(a + _BATCH_BASES, e)) for a in range(s, e - (w + k - 2), span)]


class _Batch(NamedTuple):
    pieces: list  # (record index, base offset, codes) per pseudo-record
    offsets: np.ndarray  # start of each piece in the batch buffer
    inputs: tuple  # (packed, starts, ends) host arrays
    lay: _Layout


def _batch_bases(pieces, k: int) -> int:
    """Buffer bases the pieces take in ``_plan_batch``."""
    return sum(_ceil_to(int(c.shape[0]) + k - 1, 4) for _, _, c in pieces)


def _plan_batch(pieces, k: int, w: int, n_bases: int | None = None) -> _Batch:
    """Lay pieces out in one buffer: starts aligned to 4 bases (so each
    packs byte-aligned), >= k-1 invalid bases after each.  The layout
    holds ``n_bases`` bases (default: the pieces' own), so the batches of
    one call can share a program."""
    offsets = np.zeros(len(pieces), dtype=np.int64)
    runs: list[tuple[int, int]] = []
    cursor = 0
    for r, (_, _, c) in enumerate(pieces):
        offsets[r] = cursor
        end = cursor + int(c.shape[0])
        cursor = _ceil_to(end + k - 1, 4)
        runs.append((end, cursor))
    lay = _layout(max(cursor, n_bases or 0), k, w)
    nbytes = -(-lay.buflen // 4)
    packed = np.zeros(nbytes, dtype=np.uint8)
    for r, (_, _, c) in enumerate(pieces):
        _pack2_host(c, packed, int(offsets[r]) // 4)
    runs.append((cursor, 4 * nbytes))  # buffer tail
    # one run-list length per layout (a power of two past a quarter of the
    # lanes), so an assembly's batches share one compiled program
    rcap = 1 << max(10, (max(len(runs), lay.C // 4) - 1).bit_length())
    starts = np.full(rcap, 4 * nbytes, dtype=np.int32)
    ends = np.full(rcap, 4 * nbytes, dtype=np.int32)
    starts[: len(runs)] = [s for s, _ in runs]
    ends[: len(runs)] = [e for _, e in runs]
    return _Batch(pieces, offsets, (packed, starts, ends), lay)


def _run_batch(batch: _Batch, k: int, w: int, interpret: bool, cap: int):
    return _sketch_batch(
        *batch.inputs, k=k, w=w, lay=batch.lay, cap=cap, interpret=interpret
    )


def _finish_batch(batch: _Batch, out, k: int, w: int, interpret: bool):
    """Sync one dispatched batch (re-running it under a larger cap if it
    overflowed) and split its emissions into per-piece sketches."""
    cap = _cap_for(batch.lay, w)
    count = int(out[3])
    if count > cap:  # repeat-dense batch: every emission must come back
        cap = 1 << (count - 1).bit_length()
        out = _run_batch(batch, k, w, interpret, cap)
    pos, lo, hi, _ = jax.device_get(out)
    pos = pos[:count].astype(np.int64)
    canon = lo[:count].astype(np.uint64) | (
        hi[:count].astype(np.uint64) << np.uint64(32)
    )
    hashes = derive_hash(canon, k)
    bounds = np.append(np.searchsorted(pos, batch.offsets), count)
    return [
        Sketch(
            positions=pos[bounds[r] : bounds[r + 1]] - int(batch.offsets[r]),
            hashes=hashes[bounds[r] : bounds[r + 1]],
        )
        for r in range(len(batch.pieces))
    ]


def sketch_records_gpu(
    codes_list: list[np.ndarray], k: int, w: int, interpret: bool = False
) -> list[Sketch]:
    """Minimizer sketches of many records, batched into few device programs.

    Clean records and the long clean segments of N-containing records are
    packed into batches of up to _BATCH_BASES bases; batch j+1 is
    dispatched before batch j is synced, and the host's junction-patch
    work overlaps the first batch.  Bit-identical to the NumPy oracle for
    every record.
    """
    out: list[Sketch] = [_EMPTY] * len(codes_list)
    pieces: list[tuple[int, int, np.ndarray]] = []
    patch_plans: dict[int, tuple] = {}
    whole_xla: list[int] = []
    giants: list[int] = []
    for i, c in enumerate(codes_list):
        c = np.asarray(c)
        n = int(c.shape[0])
        if k > n or w > n - k + 1:
            continue
        if n >= _I32_CAP:
            host_route(
                f"record {i} has {n} bases; device positions are int32"
            )
            giants.append(i)
            continue
        runs = _invalid_runs(c, 0)
        segs = [(0, n)]
        if runs:
            segs, nks, offs, patch_ivs, work = _patch_plan(n, runs, k, w)
            if work > max(_PATCH_WORK_MIN, n // 5):
                whole_xla.append(i)
                continue
            patch_plans[i] = (c, segs, nks, offs, patch_ivs)
        for s, e in segs:
            if e - s >= w + k - 1:
                pieces.extend((i, a, c[a:b]) for a, b in _pieces(s, e, k, w))

    # balanced batches of at most _BATCH_BASES (a piece never exceeds it)
    sizes = [int(p[2].shape[0]) + k + 2 for p in pieces]
    n_batches = max(1, -(-sum(sizes) // _BATCH_BASES))
    target = -(-sum(sizes) // n_batches)
    groups: list[list] = [[]]
    acc = 0
    for p, sz in zip(pieces, sizes):
        if groups[-1] and (acc + sz > _BATCH_BASES or (
            acc + sz > target and len(groups) < n_batches
        )):
            groups.append([])
            acc = 0
        groups[-1].append(p)
        acc += sz
    groups = [g for g in groups if g]
    # one layout for every batch of the call: one program to load
    n_bases = max((_batch_bases(g, k) for g in groups), default=0)

    def dispatch(j):
        b = _plan_batch(groups[j], k, w, n_bases)
        return b, _run_batch(b, k, w, interpret, _cap_for(b.lay, w))

    # at most two device programs in flight, each holding GBs of
    # intermediates; the host's work overlaps the first
    inflight = [dispatch(0)] if groups else []
    patches = {
        i: _patch_emissions(plan[0], k, w, *plan[1:])
        for i, plan in patch_plans.items()
    }
    for i in giants:
        out[i] = _host_sketch(np.asarray(codes_list[i]), k, w)
    if whole_xla:
        from ntjoin_tpu.ops.sketch_jax import sketch_codes_jax

        for i in whole_xla:
            out[i] = sketch_codes_jax(np.asarray(codes_list[i]), k, w)

    parts: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
    for j in range(len(groups)):
        if j + 1 < len(groups):
            inflight.append(dispatch(j + 1))
        b, o = inflight.pop(0)
        for (i, base, _), sk in zip(b.pieces, _finish_batch(b, o, k, w, interpret)):
            parts.setdefault(i, []).append((base + sk.positions, sk.hashes))
    for i, (pc, ph) in patches.items():
        if pc.shape[0]:
            parts.setdefault(i, []).append((pc, derive_hash(ph, k)))
    for i, ps in parts.items():
        if len(ps) == 1 and i not in patches:
            out[i] = Sketch(positions=ps[0][0], hashes=ps[0][1])
            continue
        pos = np.concatenate([p for p, _ in ps])
        hsh = np.concatenate([h for _, h in ps])
        order = np.argsort(pos, kind="stable")
        pos, hsh = pos[order], hsh[order]
        keep = np.empty(pos.shape[0], bool)
        keep[0] = True
        keep[1:] = pos[1:] != pos[:-1]  # overlapping pieces and patches
        out[i] = Sketch(positions=pos[keep], hashes=hsh[keep])
    return out


def sketch_codes_gpu(
    codes: np.ndarray, k: int, w: int, interpret: bool = False
) -> Sketch:
    """Minimizer sketch of one record (drop-in for the oracle's
    ``sketch_codes``)."""
    return sketch_records_gpu([codes], k, w, interpret)[0]
