"""Minimizer graph as flat arrays (edge-list + masks), built vectorized.

Re-design of the reference's igraph-based graph core (reference
``ntjoin_utils.build_graph:83-141``): instead of per-pair dict insertions and
an igraph C object, adjacent-minimizer pairs from every assembly stream are
generated as arrays and grouped with a single lexsort.  Semantics preserved:

* an edge is an unordered hash pair that is adjacent in >= 1 assembly,
* its support is the list of supporting assemblies in first-seen order
  (assembly iteration order), kept here as a bitmask over assembly indices,
* its weight is the sum of supporting assemblies' weights,
* edge order and (src, dst) orientation follow first occurrence, matching the
  reference's insertion-ordered dict so DOT dumps line up.

The ``alive`` mask supports the downstream edge filters without copying
(reference copies the whole graph per filter, ``ntjoin.py:76-77``).
"""
from __future__ import annotations

import copy

import numpy as np

from ntjoin_tpu.core.assembly import SharedIndex

try:  # scipy's C union-find when available; numpy pointer-jumping otherwise
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _scipy_cc
except ImportError:  # pragma: no cover
    _scipy_cc = None


class MinimizerGraph:
    """Undirected multigraph-free edge list over SharedIndex node ids."""

    def __init__(self, num_nodes, src, dst, weight, support_mask,
                 node_hash=None):
        self.num_nodes = int(num_nodes)
        self.src = src
        self.dst = dst
        self.weight = weight
        self.support_mask = support_mask
        self.alive = np.ones(src.shape[0], dtype=bool)
        # ascending minimizer hash per node id (the SharedIndex universe);
        # lets incremental extension translate between id spaces
        self.node_hash = node_hash
        # set by ops.device_index.build_graph_device: component labelling
        # runs on device (ops/cc_jax.py), bit-identical labels
        self.use_device_cc = False

    @property
    def num_edges(self) -> int:
        return int(self.alive.sum())

    def degrees(self, edge_mask: np.ndarray | None = None) -> np.ndarray:
        mask = self.alive if edge_mask is None else edge_mask
        deg = np.bincount(self.src[mask], minlength=self.num_nodes)
        deg += np.bincount(self.dst[mask], minlength=self.num_nodes)
        return deg

    def components(self, edge_mask: np.ndarray | None = None) -> np.ndarray:
        """Connected-component label per node (isolated nodes included)."""
        mask = self.alive if edge_mask is None else edge_mask
        s, d = self.src[mask], self.dst[mask]
        if self.use_device_cc:
            from ntjoin_tpu.ops.cc_jax import connected_components_device

            return connected_components_device(self.num_nodes, s, d)
        if _scipy_cc is not None:
            m = coo_matrix(
                (np.ones(s.shape[0], dtype=np.int8), (s, d)),
                shape=(self.num_nodes, self.num_nodes),
            )
            _, labels = _scipy_cc(m, directed=False)
            return labels
        return _pointer_jump_cc(self.num_nodes, s, d)

    def global_weight_filter(self, n_min: float, min_assembly_weight: float) -> None:
        """Drop edges below the global weight floor.

        Skipped entirely when ``n <= min(weights)``, matching reference
        ``filter_graph_global`` (``ntjoin.py:80-89``).
        """
        if n_min <= min_assembly_weight:
            return
        self.alive &= self.weight >= n_min


def _pointer_jump_cc(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Union-find-free connected components: hook minima + pointer doubling.

    O(E log N) vectorized iterations; also the blueprint for the on-device
    (JAX) label-propagation version in ``parallel/``.
    """
    parent = np.arange(n, dtype=np.int64)
    while True:
        ps, pd = parent[src], parent[dst]
        lo = np.minimum(ps, pd)
        hi = np.maximum(ps, pd)
        np.minimum.at(parent, hi, lo)
        changed = (parent[src] != parent[dst]).any() if src.size else False
        # pointer doubling to full compression
        while True:
            nxt = parent[parent]
            if (nxt == parent).all():
                break
            parent = nxt
        if not changed:
            break
    # relabel to dense ids
    _, labels = np.unique(parent, return_inverse=True)
    return labels


def build_graph(shared: SharedIndex) -> MinimizerGraph:
    """Generate the weighted minimizer adjacency graph from assembly streams."""
    n_asm = len(shared.assemblies)
    us, vs, asm_ids = [], [], []
    for a in range(n_asm):
        ids, ctgs = shared.streams[a]
        if ids.shape[0] < 2:
            continue
        same_ctg = ctgs[1:] == ctgs[:-1]
        us.append(ids[:-1][same_ctg])
        vs.append(ids[1:][same_ctg])
        asm_ids.append(np.full(int(same_ctg.sum()), a, dtype=np.int32))
    if not us:
        e = np.empty(0, dtype=np.int32)
        return MinimizerGraph(
            shared.num_nodes, e, e, np.empty(0), np.empty(0, dtype=np.int64),
            node_hash=shared.node_hash,
        )
    u = np.concatenate(us)
    v = np.concatenate(vs)
    asm = np.concatenate(asm_ids)
    occ = np.arange(u.shape[0], dtype=np.int64)

    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    order = np.lexsort((occ, hi, lo))
    lo_s, hi_s, occ_s = lo[order], hi[order], occ[order]
    u_s, v_s, asm_s = u[order], v[order], asm[order]

    new_group = np.empty(lo_s.shape[0], dtype=bool)
    new_group[0] = True
    new_group[1:] = (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])
    starts = np.flatnonzero(new_group)

    weights = np.array([a.weight for a in shared.assemblies])
    grp_weight = np.add.reduceat(weights[asm_s], starts)
    grp_mask = np.bitwise_or.reduceat(
        (np.int64(1) << asm_s.astype(np.int64)), starts
    )
    # first occurrence fixes orientation and edge ordering
    first_order = np.argsort(occ_s[starts], kind="stable")
    return MinimizerGraph(
        shared.num_nodes,
        u_s[starts][first_order].astype(np.int32),
        v_s[starts][first_order].astype(np.int32),
        grp_weight[first_order],
        grp_mask[first_order],
        node_hash=shared.node_hash,
    )


def support_names(mask: int, assemblies) -> list[str]:
    """Decode a support bitmask into assembly names in assembly order."""
    return [a.name for i, a in enumerate(assemblies) if mask & (1 << i)]


def remove_flagged_edges(
    graph: MinimizerGraph, edge_ids: np.ndarray | list[int]
) -> MinimizerGraph:
    """Copy of ``graph`` with the listed edges removed (dead).

    Mirror of the reference's ``remove_flagged_edges``
    (``ntjoin_utils.py:58-62``): the input graph is left untouched and a
    pruned copy is returned.  Only the alive mask is duplicated — the
    edge arrays are shared (mutated nowhere; a deepcopy of a Gbp-scale
    graph would duplicate millions of edges to flip a few bits).
    """
    out = copy.copy(graph)
    out.alive = graph.alive.copy()
    ids = np.asarray(edge_ids, dtype=np.int64)
    if ids.size:
        out.alive[ids] = False
    return out


def extend_graph(
    base: MinimizerGraph, shared: SharedIndex, black_list=None
) -> MinimizerGraph:
    """Incremental graph build: append new adjacency evidence to ``base``.

    Mirrors the reference's incremental ``build_graph`` mode used by sibling
    tools (``ntjoin_utils.py:87-92,118-140``): existing edges keep their
    attributes, pairs already present are skipped, and newly added edges are
    dropped again when either endpoint's total incident weight exceeds
    ``2 * sum(assembly weights)`` (``check_added_edges_incident_weights``,
    ``ntjoin_utils.py:70-80``).

    ``black_list`` (iterable of minimizer hash values) mirrors the
    reference's ``build_graph(..., black_list=...)`` pruning
    (``ntjoin_utils.py:109-113``): blacklisted minimizers are barred from
    entering the graph as NEW vertices, so fresh edges incident to a
    blacklisted minimizer outside the base graph's vertex universe are
    dropped.  (In the reference the un-added vertex makes those edges
    unconstructable; here vertices are implicit array indices, so the
    equivalent is dropping the edges directly.)

    Id spaces: base node ids index the base build's SharedIndex hash
    universe and fresh ids the new one — these DIFFER whenever the shared
    hash set changed, so everything here translates through the node
    HASHES (carried on the graphs by ``build_graph``) into the union
    universe, exactly like the reference's named igraph vertices.
    Already-present detection considers only ALIVE base edges: a pair
    pruned via :func:`remove_flagged_edges` is re-addable with fresh
    attributes, like the reference's physically deleted edges.
    """
    fresh = build_graph(shared)
    if base.src.size == 0 and black_list is None:
        return fresh
    if base.node_hash is None:
        raise ValueError("base graph lacks node_hash (not from build_graph)")

    base_hash = np.asarray(base.node_hash, dtype=np.uint64)
    new_hash = np.asarray(shared.node_hash, dtype=np.uint64)
    union = np.union1d(base_hash, new_hash)  # ascending
    m = np.int64(union.shape[0])
    b_map = np.searchsorted(union, base_hash)  # base id -> union id
    f_map = np.searchsorted(union, new_hash)  # fresh id -> union id

    def canon_keys(src, dst, idmap):
        lo = idmap[src].astype(np.int64)
        hi = idmap[dst].astype(np.int64)
        return np.minimum(lo, hi) * m + np.maximum(lo, hi)

    base_keys = np.sort(
        canon_keys(base.src[base.alive], base.dst[base.alive], b_map)
    )
    fresh_keys = canon_keys(fresh.src, fresh.dst, f_map)
    is_new = ~np.isin(fresh_keys, base_keys)

    if black_list is not None:
        bl = np.fromiter(
            (np.uint64(h) for h in black_list), dtype=np.uint64
        )
        # "existing vertex" = any hash of the base universe (isolated
        # vertices included — the reference adds every streamed minimizer
        # as a vertex, edges or not)
        blocked = np.isin(union, bl) & ~np.isin(union, base_hash)
        is_new &= ~(
            blocked[f_map[fresh.src]] | blocked[f_map[fresh.dst]]
        )

    merged = MinimizerGraph(
        int(m),
        np.concatenate(
            [b_map[base.src], f_map[fresh.src[is_new]]]
        ).astype(np.int32),
        np.concatenate(
            [b_map[base.dst], f_map[fresh.dst[is_new]]]
        ).astype(np.int32),
        np.concatenate([base.weight, fresh.weight[is_new]]),
        np.concatenate([base.support_mask, fresh.support_mask[is_new]]),
        node_hash=union,
    )
    merged.alive[: base.src.shape[0]] = base.alive

    # incident-weight guard on the added edges only
    max_expected = 2.0 * sum(a.weight for a in shared.assemblies)
    incident = np.zeros(merged.num_nodes)
    np.add.at(incident, merged.src[merged.alive], merged.weight[merged.alive])
    np.add.at(incident, merged.dst[merged.alive], merged.weight[merged.alive])
    new_slice = slice(base.src.shape[0], None)
    flagged = (incident[merged.src[new_slice]] > max_expected) | (
        incident[merged.dst[new_slice]] > max_expected
    )
    merged.alive[new_slice] &= ~flagged
    return merged
