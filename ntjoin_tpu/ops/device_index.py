"""Device-resident shared-index + minimizer-graph build (jittable XLA).

The L-filter / L-graph stages of SURVEY §7 on device, byte-equal to the
host pipeline (``core/assembly.py`` / ``graph/mingraph.py``) and therefore
to the reference semantics they replicate:

* within-assembly uniqueness — a hash duplicated inside one assembly is
  dropped from it entirely (reference ``ntjoin_utils.read_minimizers``,
  ``bin/ntjoin_utils.py:167-193``),
* all-assembly intersection (reference ``filter_minimizers``,
  ``bin/ntjoin_utils.py:152-165``),
* consecutive-pair edge tally with per-assembly support and first-seen
  edge order/orientation (reference ``build_graph``,
  ``bin/ntjoin_utils.py:83-141``).

Key identity: a hash survives iff it occurs exactly once in *every*
assembly, so one global sort by (hash, assembly) leaves the survivors as
runs of exactly ``n_asm`` elements with ascending assembly index — the
compacted (node, assembly)-major index IS the survivor rank, and a single
scatter materialises the whole shared index.  Everything downstream is
segment ops; the compacted edge list is the only device->host transfer.

Weight exactness: the host computes edge weights with a strictly
sequential ``np.add.reduceat`` over supporting assemblies in stream
order.  The device returns 4-bit per-assembly support *counts* (packed
nibbles, 8 assemblies per u32 word) and the host replays the same
ascending-assembly repeated addition, so float weights match bit-for-bit.
Counts saturating at 15 (same unordered pair adjacent >= 15 times within
one assembly) route the graph build to the host (a counted route).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ntjoin_tpu.utils.routes import host_route

_I32 = jnp.int32
_U32 = jnp.uint32


def _bucket(n: int, lo: int = 1024) -> int:
    size = lo
    while size < n:
        size *= 2
    return size


def _compact_1d(flags, cap: int, *vals):
    """Rank-compact 1-D ``vals`` where ``flags`` is set (order-preserving).

    cumsum + searchsorted + gather.
    """
    cum = jnp.cumsum(flags.astype(_I32))
    count = cum[-1]
    q = jax.lax.optimization_barrier(
        jax.lax.broadcasted_iota(_I32, (cap, 1), 0)
    )[:, 0]
    src = jnp.searchsorted(cum, q + 1, side="left").astype(_I32)
    src = jnp.minimum(src, flags.shape[0] - 1)
    live = q < count
    outs = tuple(
        jnp.where(
            live if v.ndim == 1 else live[:, None],
            v[src],
            jnp.zeros((), v.dtype),
        )
        for v in vals
    )
    return count, outs


def survive_verdict_sorted(lo, hi, asm, dead, n_asm: int):
    """Per-element survive verdict: hash occurs exactly once in EVERY assembly.

    This single predicate subsumes the reference's two filters (within-
    assembly uniqueness then all-assembly intersection — a duplicated hash
    is dropped from its assembly, so it can never satisfy presence-in-all).
    Returns (order, survive_sorted) over the sort by (dead, hash, asm).
    """
    n = lo.shape[0]
    order = jnp.lexsort((asm, lo, hi, dead.astype(_I32)))
    s_lo, s_hi = lo[order], hi[order]
    s_asm, s_dead = asm[order], dead[order]

    same_hash = jnp.concatenate(
        [jnp.zeros(1, bool), (s_lo[1:] == s_lo[:-1]) & (s_hi[1:] == s_hi[:-1])]
    )
    same_group = same_hash & ~s_dead & jnp.concatenate([jnp.ones(1, bool), ~s_dead[:-1]])
    new_group = ~same_group
    gid = jnp.cumsum(new_group.astype(_I32)) - 1

    seg_size = jnp.zeros(n, _I32).at[gid].add(1)
    dup_adj = same_group & (s_asm == jnp.concatenate([jnp.full(1, -1, _I32), s_asm[:-1]]))
    seg_dup = jnp.zeros(n, bool).at[gid].max(dup_adj)
    survive_g = (seg_size == n_asm) & ~seg_dup
    return order, survive_g[gid] & ~s_dead


@partial(jax.jit, static_argnames=("n_asm", "cap_nodes"))
def _shared_filter(lo, hi, asm, ctg, pos, dead, n_asm: int, cap_nodes: int):
    """Uniqueness + intersection over padded concatenated streams.

    Inputs are the assemblies' minimizer streams concatenated in assembly
    order (original sketch order preserved), padded with ``dead`` entries.
    Returns the (node, assembly)-major shared index plus per-element stream
    node ids in original order.
    """
    n = lo.shape[0]
    order, survive = survive_verdict_sorted(lo, hi, asm, dead, n_asm)
    s_lo, s_hi = lo[order], hi[order]

    # survivor rank = nid * n_asm + asm (groups are hash-ascending, members
    # assembly-ascending, exactly one per assembly)
    rank = jnp.cumsum(survive.astype(_I32)) - 1
    num_nodes = (rank[-1] + 1) // n_asm

    tab = cap_nodes * n_asm
    dest = jnp.where(survive, rank, tab)
    t_lo = jnp.zeros(tab, _U32).at[dest].set(s_lo, mode="drop")
    t_hi = jnp.zeros(tab, _U32).at[dest].set(s_hi, mode="drop")
    t_ctg = jnp.zeros(tab, _I32).at[dest].set(ctg[order], mode="drop")
    t_pos = jnp.zeros(tab, _I32).at[dest].set(pos[order], mode="drop")

    # per-element node id back in ORIGINAL stream order
    nid_sorted = jnp.where(survive, rank // n_asm, -1)
    nid = jnp.full(n, -1, _I32).at[order].set(nid_sorted)
    return t_lo, t_hi, t_ctg, t_pos, nid, num_nodes


@partial(jax.jit, static_argnames=("cap_edges",))
def _edge_tally_exact(nid, ctg, asm, num_nodes, cap_edges: int):
    """First-seen-ordered edge groups with exact per-assembly counts.

    ``nid``/``ctg``/``asm`` are the *compacted* shared streams in original
    order (dead tail = -1).  Returns cap-bounded (lo, hi, counts4, min_enc)
    where min_enc = 2*first_occurrence + (u > v at that occurrence).
    """
    n = nid.shape[0]
    u, v = nid[:-1], nid[1:]
    pair_alive = (
        (u >= 0)
        & (v >= 0)
        & (asm[1:] == asm[:-1])
        & (ctg[1:] == ctg[:-1])
    )
    sent = num_nodes.astype(_I32)
    p_lo = jnp.where(pair_alive, jnp.minimum(u, v), sent)
    p_hi = jnp.where(pair_alive, jnp.maximum(u, v), sent)
    order = jnp.lexsort((p_hi, p_lo))
    l_s, h_s = p_lo[order], p_hi[order]
    a_s = asm[:-1][order]
    occ_s = order.astype(_I32)
    flip_s = (u > v)[order]

    new_group = jnp.concatenate(
        [jnp.ones(1, bool), (l_s[1:] != l_s[:-1]) | (h_s[1:] != h_s[:-1])]
    )
    seg = jnp.cumsum(new_group.astype(_I32)) - 1
    m = n - 1
    alive_s = l_s < sent
    word = jnp.where(alive_s, a_s // 8, 0)
    shift = (4 * (a_s % 8)).astype(_U32)
    counts = jnp.zeros((m, 4), _U32).at[seg, word].add(
        jnp.where(alive_s, _U32(1) << shift, _U32(0))
    )
    enc = jnp.where(alive_s, occ_s * 2 + flip_s.astype(_I32), jnp.iinfo(np.int32).max)
    min_enc = jnp.full(m, jnp.iinfo(np.int32).max, _I32).at[seg].min(enc)
    g_lo = jnp.full(m, sent, _I32).at[seg].min(l_s)
    g_hi = jnp.full(m, sent, _I32).at[seg].min(h_s)
    # compact one representative element per live group (group-start slots
    # carry their group's finished segment values)
    valid = new_group & (l_s < sent)
    n_edges, (o_lo, o_hi, o_counts, o_enc) = _compact_1d(
        valid, cap_edges, g_lo[seg], g_hi[seg], counts[seg], min_enc[seg]
    )
    return o_lo, o_hi, o_counts, o_enc, n_edges


def shared_index_device(assemblies):
    """Device-path drop-in for ``SharedIndex(assemblies)``.

    Runs uniqueness + intersection in one jitted program; returns a
    SharedIndex-compatible object whose arrays came off the device.
    """
    from ntjoin_tpu.core.assembly import SharedIndex
    from ntjoin_tpu.utils.jaxcfg import enable_compile_cache

    enable_compile_cache()
    n_asm = len(assemblies)
    # device positions are int32: a >= 2^31 bp contig (its sketch came
    # from the host path, which has no size limit) would WRAP silently in
    # the astype below — the bit-exact host index takes it instead
    for a in assemblies:
        if a.pos.size and int(a.pos.max()) >= 2**31:
            host_route(f"{a.name}: minimizer positions past int32")
            return SharedIndex(assemblies)
    lens = [a.hash.shape[0] for a in assemblies]
    total = sum(lens)
    padded = _bucket(max(total, 1))
    cap_nodes = _bucket(max(min(lens), 1)) if min(lens) else 1024

    lo = np.zeros(padded, np.uint32)
    hi = np.zeros(padded, np.uint32)
    asm = np.zeros(padded, np.int32)
    ctg = np.zeros(padded, np.int32)
    pos = np.zeros(padded, np.int32)
    dead = np.ones(padded, bool)
    cursor = 0
    for a, sk in enumerate(assemblies):
        m = lens[a]
        h = sk.hash
        lo[cursor : cursor + m] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi[cursor : cursor + m] = (h >> np.uint64(32)).astype(np.uint32)
        asm[cursor : cursor + m] = a
        ctg[cursor : cursor + m] = sk.ctg
        pos[cursor : cursor + m] = sk.pos.astype(np.int32)
        dead[cursor : cursor + m] = False
        cursor += m

    t_lo, t_hi, t_ctg, t_pos, nid, num_nodes = _shared_filter(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(asm), jnp.asarray(ctg),
        jnp.asarray(pos), jnp.asarray(dead), n_asm, cap_nodes,
    )
    nn = int(num_nodes)
    t_lo = np.asarray(t_lo[: nn * n_asm]).reshape(nn, n_asm)
    t_hi = np.asarray(t_hi[: nn * n_asm]).reshape(nn, n_asm)
    t_ctg = np.asarray(t_ctg[: nn * n_asm]).reshape(nn, n_asm)
    t_pos = np.asarray(t_pos[: nn * n_asm]).reshape(nn, n_asm)
    nid_np = np.asarray(nid[:total])

    shared = SharedIndex.__new__(SharedIndex)
    shared.assemblies = assemblies
    shared.node_hash = t_lo[:, 0].astype(np.uint64) | (
        t_hi[:, 0].astype(np.uint64) << np.uint64(32)
    )
    shared.pos = t_pos.T.astype(np.int64)
    shared.ctg = t_ctg.T.astype(np.int32)
    shared.streams = []
    cursor = 0
    for a in range(n_asm):
        ids_a = nid_np[cursor : cursor + lens[a]]
        keep = ids_a >= 0
        ids_k = ids_a[keep].astype(np.int32)
        shared.streams.append((ids_k, assemblies[a].ctg[keep]))
        cursor += lens[a]
    shared._device_nid = nid_np  # reused by build_graph_device
    shared._device_lens = lens
    return shared


def build_graph_device(shared):
    """Device-path drop-in for ``graph.mingraph.build_graph`` (byte-equal).

    Edge tally on device; the host restores first-occurrence order and
    orientation and replays the reference's sequential weight summation
    from the returned per-assembly counts.  Falls back to the host builder
    if a support count saturates its 4-bit nibble.
    """
    from ntjoin_tpu.graph.mingraph import MinimizerGraph, build_graph

    n_asm = len(shared.assemblies)
    if n_asm > 32:
        host_route(f"{n_asm} assemblies: the device support mask holds 32")
        return build_graph(shared)
    nn = shared.num_nodes
    total = sum(ids.shape[0] for ids, _ in shared.streams)
    if total < 2 or nn == 0:
        return build_graph(shared)
    padded = _bucket(total)
    nid = np.full(padded, -1, np.int32)
    ctg = np.full(padded, -1, np.int32)
    asm = np.full(padded, -1, np.int32)
    cursor = 0
    for a, (ids, ctgs) in enumerate(shared.streams):
        m = ids.shape[0]
        nid[cursor : cursor + m] = ids
        ctg[cursor : cursor + m] = ctgs
        asm[cursor : cursor + m] = a
        cursor += m
    # every assembly stream visits each node at most once, so it adds at
    # most nn - 1 distinct edges: the cap cannot overflow
    cap_edges = _bucket(min(n_asm * nn, total))
    o_lo, o_hi, o_counts, o_enc, n_edges = _edge_tally_exact(
        jnp.asarray(nid), jnp.asarray(ctg), jnp.asarray(asm),
        jnp.asarray(np.int32(nn)), cap_edges,
    )
    ne = int(n_edges)
    if ne > cap_edges:  # the visit bound above failed: never truncate
        raise RuntimeError(
            f"device edge tally found {ne} edges, past its cap {cap_edges}"
        )
    o_lo = np.asarray(o_lo[:ne]).astype(np.int64)
    o_hi = np.asarray(o_hi[:ne]).astype(np.int64)
    o_counts = np.asarray(o_counts[:ne])
    o_enc = np.asarray(o_enc[:ne]).astype(np.int64)

    # per-assembly counts from packed nibbles
    counts = np.zeros((ne, n_asm), np.int64)
    for a in range(n_asm):
        counts[:, a] = (o_counts[:, a // 8] >> np.uint32(4 * (a % 8))) & np.uint32(0xF)
    if (counts == 15).any():
        host_route("an edge support count saturates its 4-bit field")
        return build_graph(shared)

    # first-occurrence ordering and orientation (reference dict insertion
    # order; host mingraph.build_graph does the same via argsort of occ)
    first = np.argsort(o_enc, kind="stable")
    flip = (o_enc[first] & 1).astype(bool)
    lo_f, hi_f = o_lo[first], o_hi[first]
    src = np.where(flip, hi_f, lo_f).astype(np.int32)
    dst = np.where(flip, lo_f, hi_f).astype(np.int32)
    counts = counts[first]

    # bit-exact weights: rebuild the host path's per-group weight sequence
    # (supporting occurrences in ascending assembly order) and hand it to
    # the same np.add.reduceat the host builder uses — reduceat's float
    # association is not plain left-to-right, so replaying the reduction
    # itself is the only safe way to match it
    weights = np.array([a.weight for a in shared.assemblies])
    if ne:
        seq = np.repeat(np.tile(weights, ne), counts.ravel())
        lens = counts.sum(axis=1)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        weight = np.add.reduceat(seq, starts)
    else:
        weight = np.zeros(0)
    support = np.zeros(ne, np.int64)
    for a in range(n_asm):
        support |= np.where(counts[:, a] > 0, np.int64(1) << a, 0)

    g = MinimizerGraph(nn, src, dst, weight, support)
    g.use_device_cc = True  # component labelling on device (ops/cc_jax.py)
    return g
