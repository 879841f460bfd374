"""Byte-parity of the device shared-index/graph path vs the host path."""
import numpy as np
import pytest


def test_device_cc_matches_host():
    """Device pointer-jump CC labels == host labels (scipy/min-hook) on a
    random sparse graph with many components."""
    from ntjoin_tpu.graph.mingraph import MinimizerGraph
    from ntjoin_tpu.ops.cc_jax import connected_components_device

    rng = np.random.default_rng(3)
    n = 50_000
    m = 60_000
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    g = MinimizerGraph(n, src, dst, np.ones(m), np.ones(m, np.int64))
    host = g.components()
    dev = connected_components_device(n, src, dst)
    assert dev.tolist() == host.tolist()


def test_device_cc_chain_and_isolated():
    from ntjoin_tpu.ops.cc_jax import connected_components_device

    # two chains + isolated nodes
    src = np.array([0, 1, 5, 6], np.int32)
    dst = np.array([1, 2, 6, 7], np.int32)
    labels = connected_components_device(9, src, dst)
    assert labels.tolist() == [0, 0, 0, 1, 2, 3, 3, 3, 4]

from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
from ntjoin_tpu.graph.mingraph import build_graph
from ntjoin_tpu.ops.device_index import build_graph_device, shared_index_device


def _mk_assemblies(seed, n_asm=3, n_ctg=4, per_ctg=200, dup_frac=0.1):
    """Random assemblies over a shared hash pool with planted duplicates."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(
        0, 2**63, size=per_ctg * n_ctg * 4, dtype=np.uint64
    )
    pool = np.unique(pool)[: per_ctg * n_ctg * 2]
    assemblies = []
    for a in range(n_asm):
        hs, ps, cs = [], [], []
        for c in range(n_ctg):
            m = per_ctg + int(rng.integers(-50, 50))
            h = rng.choice(pool, size=m, replace=False)
            # plant within-assembly duplicates
            ndup = int(m * dup_frac)
            if ndup:
                h[rng.choice(m, ndup, replace=False)] = rng.choice(h, ndup)
            p = np.sort(rng.choice(10**6, size=m, replace=False))
            hs.append(h)
            ps.append(p)
            cs.append(np.full(m, c, np.int32))
        assemblies.append(
            AssemblySketch.from_stream(
                f"asm{a}", float(a + 1), [f"c{c}" for c in range(n_ctg)],
                np.concatenate(hs), np.concatenate(ps), np.concatenate(cs),
            )
        )
    return assemblies


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_index_parity(seed):
    assemblies = _mk_assemblies(seed)
    host = SharedIndex(assemblies)
    dev = shared_index_device(assemblies)
    assert dev.node_hash.tolist() == host.node_hash.tolist()
    assert (dev.pos == host.pos).all()
    assert (dev.ctg == host.ctg).all()
    for (di, dc), (hi_, hc) in zip(dev.streams, host.streams):
        assert di.tolist() == hi_.tolist()
        assert dc.tolist() == hc.tolist()


@pytest.mark.parametrize("seed", [0, 3])
def test_graph_parity(seed):
    assemblies = _mk_assemblies(seed)
    host_g = build_graph(SharedIndex(assemblies))
    dev_g = build_graph_device(shared_index_device(assemblies))
    assert dev_g.num_nodes == host_g.num_nodes
    assert dev_g.src.tolist() == host_g.src.tolist()
    assert dev_g.dst.tolist() == host_g.dst.tolist()
    assert dev_g.weight.tolist() == host_g.weight.tolist()
    assert dev_g.support_mask.tolist() == host_g.support_mask.tolist()


def test_graph_parity_fractional_weights():
    assemblies = _mk_assemblies(4)
    for a, wt in zip(assemblies, (0.1, 1.7, 2.0)):
        a.weight = wt
    host_g = build_graph(SharedIndex(assemblies))
    dev_g = build_graph_device(shared_index_device(assemblies))
    # exact float equality: the host replays reduceat's sequential order
    assert dev_g.weight.tolist() == host_g.weight.tolist()


def test_graph_parity_repeated_adjacency():
    """Same unordered pair adjacent several times within one assembly."""
    n_ctg = 1
    h = np.array([11, 22, 11, 33, 44], dtype=np.uint64)
    # stream A-B-A produces (11,22) and (22,11): one canonical pair, twice
    a0 = AssemblySketch.from_stream(
        "a0", 0.3, ["c"], h,
        np.arange(5, dtype=np.int64), np.zeros(5, np.int32),
    )
    # second assembly: all five hashes once, different order
    h1 = np.array([22, 11, 33, 44, 55], dtype=np.uint64)
    a1 = AssemblySketch.from_stream(
        "a1", 2.0, ["c"], h1,
        np.arange(5, dtype=np.int64), np.zeros(5, np.int32),
    )
    # a0 has 11 twice -> 11 dropped from a0 entirely -> fails intersection
    host = SharedIndex([a0, a1])
    dev = shared_index_device([a0, a1])
    assert dev.node_hash.tolist() == host.node_hash.tolist()
    host_g = build_graph(host)
    dev_g = build_graph_device(dev)
    assert dev_g.src.tolist() == host_g.src.tolist()
    assert dev_g.weight.tolist() == host_g.weight.tolist()


def test_empty_intersection():
    a0 = AssemblySketch.from_stream(
        "a0", 1.0, ["c"], np.array([1, 2], np.uint64),
        np.array([0, 10], np.int64), np.zeros(2, np.int32),
    )
    a1 = AssemblySketch.from_stream(
        "a1", 1.0, ["c"], np.array([3, 4], np.uint64),
        np.array([0, 10], np.int64), np.zeros(2, np.int32),
    )
    dev = shared_index_device([a0, a1])
    assert dev.num_nodes == 0
    g = build_graph_device(dev)
    assert g.num_edges == 0


def test_shared_index_device_big_position_fallback():
    """Positions >= 2^31 cannot ride the device's int32 arrays: the
    device index must fall back to the bit-exact host SharedIndex
    instead of silently wrapping (round-5 review)."""
    import numpy as np

    from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
    from ntjoin_tpu.ops.device_index import shared_index_device

    def asm(name, pos0):
        return AssemblySketch.from_stream(
            name, 1.0, ["c"],
            np.array([11, 22, 33], dtype=np.uint64),
            np.array([pos0, pos0 + 100, pos0 + 200], dtype=np.int64),
            np.zeros(3, dtype=np.int32),
        )

    from ntjoin_tpu.utils import routes

    big = 2**31 + 5
    routes.reset()
    got = shared_index_device([asm("a", big), asm("b", 0)])
    assert routes.host_routes() == 1  # a counted capacity route
    ref = SharedIndex([asm("a", big), asm("b", 0)])
    assert got.node_hash.tolist() == ref.node_hash.tolist()
    assert (got.pos == ref.pos).all()  # no int32 wrap
    assert int(got.pos.max()) > 2**31


def test_graph_device_many_assemblies_routes_to_host():
    """Past 32 assemblies the device support mask cannot hold the tally:
    a counted host route with the host builder's exact graph."""
    from ntjoin_tpu.utils import routes

    asms = _mk_assemblies(5, n_asm=33, n_ctg=2, per_ctg=60, dup_frac=0.0)
    shared = SharedIndex(asms)
    routes.reset()
    dev_g = build_graph_device(shared)
    assert routes.host_routes() == 1
    host_g = build_graph(shared)
    assert dev_g.src.tolist() == host_g.src.tolist()
    assert dev_g.weight.tolist() == host_g.weight.tolist()


def test_graph_device_support_saturation_routes_to_host():
    """An unordered pair adjacent 15+ times in one assembly saturates its
    4-bit support count: a counted host route, exact graph."""
    from ntjoin_tpu.utils import routes

    # the pair 11-22 once in each of 15 contigs of a0 (real streams hold a
    # node once per assembly; the tiled stream forces the saturation)
    n = 15
    h0 = np.array([11, 22], np.uint64)
    a0 = AssemblySketch.from_stream(
        "a0", 1.0, ["c"], h0, np.array([0, 10], np.int64), np.zeros(2, np.int32)
    )
    a1 = AssemblySketch.from_stream(
        "a1", 1.0, ["c"], h0, np.array([0, 10], np.int64), np.zeros(2, np.int32)
    )
    shared = SharedIndex([a0, a1])
    # replay the same stream many times: counts past the nibble
    ids, ctgs = shared.streams[0]
    shared.streams[0] = (np.tile(ids, n), np.repeat(np.arange(n, dtype=np.int32), 2))
    routes.reset()
    dev_g = build_graph_device(shared)
    assert routes.host_routes() == 1
    host_g = build_graph(shared)
    assert dev_g.weight.tolist() == host_g.weight.tolist()


def test_graph_device_edge_cap_overflow_raises():
    """The edge cap rests on each stream visiting a node at most once; a
    stream that breaks it must raise, never come back truncated."""
    nodes = 60
    h = np.arange(1, nodes + 1, dtype=np.uint64) * np.uint64(7919)
    pos = np.arange(nodes, dtype=np.int64) * 10
    asms = [
        AssemblySketch.from_stream(n, 1.0, ["c"], h, pos, np.zeros(nodes, np.int32))
        for n in ("a0", "a1")
    ]
    shared = SharedIndex(asms)
    assert shared.num_nodes == nodes
    # every pair of nodes adjacent once: 1,770 distinct edges from 60 nodes
    i, j = np.triu_indices(nodes, 1)
    ids = np.stack([i, j], 1).reshape(-1).astype(np.int32)
    shared.streams[0] = (ids, np.repeat(np.arange(i.shape[0], dtype=np.int32), 2))
    with pytest.raises(RuntimeError, match="past its cap"):
        build_graph_device(shared)


def test_device_cc_error_raises(monkeypatch):
    """The device component labelling failing is an error, not a silent
    host run."""
    import ntjoin_tpu.ops.cc_jax as cc
    from ntjoin_tpu.graph.mingraph import MinimizerGraph

    def boom(*a, **kw):
        raise RuntimeError("device failure")

    monkeypatch.setattr(cc, "connected_components_device", boom)
    g = MinimizerGraph(3, np.array([0]), np.array([1]), np.ones(1),
                       np.ones(1, np.int64))
    g.use_device_cc = True
    with pytest.raises(RuntimeError, match="device failure"):
        g.components()
