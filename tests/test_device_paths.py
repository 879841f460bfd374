"""Device path-extraction passes vs the host oracle (bit-equality)."""
import copy

import numpy as np
import pytest

from ntjoin_tpu.graph.mingraph import MinimizerGraph


def _random_graph(rng, n_nodes, n_edges, n_asm=2):
    """Random simple undirected graph as a MinimizerGraph."""
    pairs = set()
    src, dst = [], []
    while len(src) < n_edges:
        a, b = rng.integers(0, n_nodes, 2)
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        if key in pairs:
            continue
        pairs.add(key)
        src.append(int(a))
        dst.append(int(b))
    weight = rng.integers(1, 6, len(src)).astype(np.float64)
    support = rng.integers(1, 1 << n_asm, len(src)).astype(np.int64)
    return MinimizerGraph(
        n_nodes,
        np.array(src, np.int64),
        np.array(dst, np.int64),
        weight,
        support,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_escalate_filter_device_matches_host(seed):
    from ntjoin_tpu.graph.paths import escalating_branch_filter
    from ntjoin_tpu.ops.device_paths import escalate_filter_device

    rng = np.random.default_rng(seed)
    g_host = _random_graph(rng, 400, 700)
    g_dev = copy.deepcopy(g_host)
    comp = g_host.components()
    n_min, max_w = 2.0, 5.0
    escalating_branch_filter(g_host, comp, n_min, max_w)
    alive_dev = escalate_filter_device(g_dev, comp, n_min, max_w)
    assert (alive_dev == g_host.alive).all()


def test_rank_walker_matches_native_walk():
    """Half-edge list ranking reproduces the sequential chain walk for a
    forest of chains of assorted lengths (plus an untouched cycle)."""
    from ntjoin_tpu.graph.paths import _walk_chain
    from ntjoin_tpu.ops.device_paths import make_rank_walker

    # chains: 0-1-2-3-4, 5-6, 7 alone, 8-9-10; cycle: 11-12-13-11
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (5, 6), (8, 9), (9, 10),
             (11, 12), (12, 13), (13, 11)]
    n = 14
    n1 = np.full(n, -1, np.int32)
    n2 = np.full(n, -1, np.int32)
    e1 = np.full(n, -1, np.int32)
    e2 = np.full(n, -1, np.int32)
    for eid, (a, b) in enumerate(edges):
        for u, v in ((a, b), (b, a)):
            if n1[u] < 0:
                n1[u], e1[u] = v, eid
            elif n2[u] < 0:
                n2[u], e2[u] = v, eid
    walker = make_rank_walker(n1, n2, e1, e2)
    for source, length in [(0, 5), (4, 5), (5, 2), (6, 2), (8, 3), (10, 3)]:
        ref_nodes, ref_eids = _walk_chain(n1, n2, e1, e2, source, length)
        got_nodes, got_eids = walker.walk(source)
        assert got_nodes.tolist() == ref_nodes.tolist(), source
        assert got_eids.tolist() == ref_eids.tolist(), source


@pytest.mark.parametrize("seed", [3, 4])
def test_find_paths_device_matches_host(seed):
    """find_paths(device=True) returns identical paths on graphs with
    chains, branches and circular components."""
    from ntjoin_tpu.core.assembly import SharedIndex
    from ntjoin_tpu.graph.paths import find_paths

    rng = np.random.default_rng(seed)
    n_nodes = 300
    g_host = _random_graph(rng, n_nodes, 360)

    class _Asm:
        def __init__(self, weight, pos):
            self.weight = weight
            self.pos = pos

    # minimal SharedIndex stand-in: find_paths touches .assemblies[i].weight
    # and shared.pos[a] only
    class _Shared:
        def __init__(self):
            self.assemblies = [_Asm(2.0, None), _Asm(1.0, None)]
            self.pos = [
                rng.permutation(n_nodes).astype(np.int64),
                rng.permutation(n_nodes).astype(np.int64),
            ]

    shared = _Shared()
    g_dev = copy.deepcopy(g_host)
    host_paths, host_n = find_paths(g_host, shared, 2.0, device=False)
    dev_paths, dev_n = find_paths(g_dev, shared, 2.0, device=True)
    assert dev_n == host_n
    assert len(dev_paths) == len(host_paths)
    for (hp, _), (dp, _) in zip(host_paths, dev_paths):
        assert dp == hp
    assert (g_dev.alive == g_host.alive).all()


def test_escalate_filter_fractional_weights():
    """Fractional weights that don't round-trip f64->f32 must NOT be
    compared in f32 on device (round-4 verdict): the device pass raises
    (caller falls back to the host filter), while f32-exact fractional
    weights still run on device bit-equal to the host."""
    from ntjoin_tpu.graph.paths import escalating_branch_filter
    from ntjoin_tpu.ops.device_paths import escalate_filter_device

    rng = np.random.default_rng(9)
    g = _random_graph(rng, 300, 520)

    # 0.1 + 0.3 style sums are not f32-exact -> refuse
    g_bad = copy.deepcopy(g)
    g_bad.weight = g_bad.weight * 0.1
    with pytest.raises(ValueError):
        escalate_filter_device(g_bad, g_bad.components(), 1.0, 0.5)

    # 0.25 / 0.5 style weights round-trip exactly -> device == host
    g_host = copy.deepcopy(g)
    g_host.weight = g_host.weight * 0.25
    g_dev = copy.deepcopy(g_host)
    comp = g_host.components()
    n_min, max_w = 0.5, float(g_host.weight.max())
    escalating_branch_filter(g_host, comp, n_min, max_w)
    alive_dev = escalate_filter_device(g_dev, comp, n_min, max_w)
    assert (alive_dev == g_host.alive).all()


def test_find_paths_device_fractional_weight_fallback(monkeypatch):
    """find_paths(device=True) with non-f32-exact weights takes the host
    filter as a counted host route (the device filter is never started)
    and still matches find_paths(device=False)."""
    from ntjoin_tpu.graph import paths as paths_mod
    from ntjoin_tpu.utils import routes

    called = {"device": 0}
    import ntjoin_tpu.ops.device_paths as dp

    orig = dp.escalate_filter_device

    def spy(*a, **kw):
        called["device"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(dp, "escalate_filter_device", spy)

    rng = np.random.default_rng(12)
    g = _random_graph(rng, 200, 340)
    g.weight = g.weight * 0.1  # not f32-exact

    class _Asm:
        def __init__(self, w):
            self.weight = w

    class _Shared:
        assemblies = [_Asm(0.1), _Asm(0.3)]

    g_host = copy.deepcopy(g)
    g_dev = copy.deepcopy(g)
    res_host = paths_mod.find_paths(g_host, _Shared(), 0.1, device=False)
    routes.reset()
    res_dev = paths_mod.find_paths(g_dev, _Shared(), 0.1, device=True)
    assert called["device"] == 0  # refused up front, before device work
    assert routes.host_routes() == 1
    assert (g_host.alive == g_dev.alive).all()
    assert repr(res_host) == repr(res_dev)


def test_weights_exact_f32():
    from ntjoin_tpu.ops.device_paths import weights_exact_f32

    assert weights_exact_f32(np.array([1.0, 2.5, 0.25]), 2.0, 3.0)
    assert not weights_exact_f32(np.array([0.1, 1.0]), 2.0, 3.0)
    assert not weights_exact_f32(np.array([1.0]), 0.3, 3.0)
    assert not weights_exact_f32(np.array([1.0]), 2.0, 2.0**24)


@pytest.mark.parametrize("where", ["filter", "walker"])
def test_find_paths_device_error_raises(monkeypatch, where):
    """A failing device pass is an error, never a silent host run."""
    import ntjoin_tpu.ops.device_paths as dp
    from ntjoin_tpu.graph.paths import find_paths

    def boom(*a, **kw):
        raise RuntimeError("device failure")

    name = "escalate_filter_device" if where == "filter" else "make_rank_walker"
    monkeypatch.setattr(dp, name, boom)
    rng = np.random.default_rng(3)
    g = _random_graph(rng, 120, 150)

    class _Asm:
        def __init__(self, w):
            self.weight = w

    class _Shared:
        assemblies = [_Asm(2.0), _Asm(1.0)]
        pos = [np.arange(120, dtype=np.int64), np.arange(120, dtype=np.int64)]

    with pytest.raises(RuntimeError, match="device failure"):
        find_paths(g, _Shared(), 2.0, device=True)
