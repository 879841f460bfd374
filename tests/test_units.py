"""Unit tests for engine components with no end-to-end coverage elsewhere."""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from ntjoin_tpu.core.orientation import determine_orientation, mann_kendall
from ntjoin_tpu.core.overlap_region import OverlapRegionResolver
from ntjoin_tpu.core.pathnode import Bed, PathNode
from ntjoin_tpu.ops.intervals import complement, self_intersect_counts, sort_beds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestOverlapRegionResolver:
    def test_subsumed_dropped(self):
        r = OverlapRegionResolver()
        r.add(Bed("c", 0, 100))
        r.add(Bed("c", 10, 50))
        fixes = r.resolve()
        assert fixes[Bed("c", 0, 100)] == Bed("c", 0, 100)
        assert fixes[Bed("c", 10, 50)] is None

    def test_partial_overlap_trimmed_to_abut(self):
        r = OverlapRegionResolver()
        r.add(Bed("c", 0, 100))
        r.add(Bed("c", 80, 250))  # longer -> best
        fixes = r.resolve()
        assert fixes[Bed("c", 80, 250)] == Bed("c", 80, 250)
        assert fixes[Bed("c", 0, 100)] == Bed("c", 0, 79)

    def test_iterative_fixup_chain(self):
        r = OverlapRegionResolver()
        r.add(Bed("c", 0, 100))
        r.add(Bed("c", 90, 300))  # best
        r.add(Bed("c", 95, 180))
        fixes = r.resolve()
        survivors = sorted(b for b in fixes.values() if b is not None)
        for a, b in zip(survivors, survivors[1:]):
            assert not (a.start <= b.end and b.start <= a.end)


class TestIntervals:
    def test_sort_and_counts(self):
        beds = [Bed("b", 5, 10), Bed("a", 0, 4), Bed("a", 2, 8)]
        s = sort_beds(beds)
        assert s[0].contig == "a" and s[0].start == 0
        counts = self_intersect_counts(s)
        assert counts == [2, 2, 1]

    def test_counts_half_open(self):
        # abutting half-open intervals do not overlap
        beds = [Bed("a", 0, 5), Bed("a", 5, 10)]
        assert self_intersect_counts(beds) == [1, 1]

    def test_complement(self):
        beds = [Bed("a", 2, 5), Bed("a", 4, 9)]
        out = complement(beds, [("a", 12), ("b", 3)])
        assert out == [Bed("a", 0, 2), Bed("a", 9, 12), Bed("b", 0, 3)]


class TestOrientation:
    def test_strict(self):
        assert determine_orientation([1, 5, 9], False, 90) == "+"
        assert determine_orientation([9, 5, 1], False, 90) == "-"
        assert determine_orientation([5], False, 90) == "?"

    def test_vote(self):
        pos = list(range(0, 200, 10)) + [5]  # 20/21 increasing pairs
        assert determine_orientation(pos, False, 90) == "+"
        assert determine_orientation(pos[::-1], False, 90) == "-"
        assert determine_orientation([1, 9, 2, 8, 3], False, 90) == "?"

    def test_mann_kendall_statistics(self):
        # classic MK example: strong upward trend with noise
        data = [12, 15, 14, 18, 21, 19, 25, 28, 26, 30, 33, 31]
        trend, h, p, z = mann_kendall(data)
        assert trend == "increasing" and h
        assert p < 0.001
        # reversed data mirrors z
        _, _, p2, z2 = mann_kendall(data[::-1])
        assert math.isclose(p, p2, rel_tol=1e-12)
        assert math.isclose(z, -z2, rel_tol=1e-12)

    def test_mkt_orientation_where_vote_fails(self):
        data = [12, 15, 14, 18, 21, 19, 25, 28, 26, 30, 33, 31]
        assert determine_orientation(data, False, 90) == "?"
        assert determine_orientation(data, True, 90) == "+"
        assert determine_orientation(data[::-1], True, 90) == "-"


class TestPathNode:
    def test_adjusted_coordinates(self):
        node = PathNode("c", "+", 100, 400, 1000, 0, 1)
        assert node.aligned_length == 300
        node.start_adjust = 10
        node.end_adjust = 250
        assert node.adjusted_start() == 110
        assert node.adjusted_end() == 400 - (300 - 250)
        rev = PathNode("c", "-", 100, 400, 1000, 0, 1)
        rev.start_adjust = 10
        rev.end_adjust = 250
        assert rev.adjusted_start() == 100 + (300 - 250)
        assert rev.adjusted_end() == 400 - 10


class TestIncrementalGraph:
    def test_extend_skips_existing_and_guards(self):
        from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
        from ntjoin_tpu.graph.mingraph import build_graph, extend_graph

        def asm(name, weight, hashes):
            return AssemblySketch.from_stream(
                name, weight, ["c"],
                np.array(hashes, dtype=np.uint64),
                np.arange(len(hashes), dtype=np.int64) * 100,
                np.zeros(len(hashes), dtype=np.int32),
            )

        shared = SharedIndex([asm("a", 2.0, [11, 22, 33]), asm("b", 1.0, [11, 22, 33])])
        g1 = build_graph(shared)
        g2 = extend_graph(g1, shared)
        # nothing new: same alive edge count
        assert g2.num_edges == g1.num_edges

    def test_extend_black_list_prunes_new_vertices(self):
        """black_list parity (reference ntjoin_utils.py:109-113 via
        build_graph's incremental mode): blacklisted minimizers cannot
        enter the graph as NEW vertices, so fresh edges touching them are
        pruned — but edges to blacklisted minimizers ALREADY in the base
        graph still extend it."""
        from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
        from ntjoin_tpu.graph.mingraph import build_graph, extend_graph

        def asm(name, weight, hashes):
            return AssemblySketch.from_stream(
                name, weight, ["c"],
                np.array(hashes, dtype=np.uint64),
                np.arange(len(hashes), dtype=np.int64) * 100,
                np.zeros(len(hashes), dtype=np.int32),
            )

        base_shared = SharedIndex(
            [asm("a", 2.0, [11, 22]), asm("b", 1.0, [11, 22])]
        )
        g1 = build_graph(base_shared)
        assert g1.num_edges == 1

        # extended index introduces minimizers 33 (blacklisted, new) and
        # 44 (clean, new); 22 is blacklisted but already in the base graph
        ext_shared = SharedIndex(
            [asm("a", 2.0, [11, 22, 33, 44]), asm("b", 1.0, [11, 22, 33, 44])]
        )
        g_nobl = extend_graph(g1, ext_shared)
        assert g_nobl.num_edges == 3  # 11-22 (kept), 22-33, 33-44

        g_bl = extend_graph(g1, ext_shared, black_list=[22, 33])
        pairs = {
            tuple(sorted((int(ext_shared.node_hash[s]),
                          int(ext_shared.node_hash[t]))))
            for s, t in zip(g_bl.src[g_bl.alive], g_bl.dst[g_bl.alive])
        }
        # 22-33 and 33-44 blocked (33 is a new blacklisted vertex);
        # base 11-22 untouched (22 pre-exists in the base graph)
        assert pairs == {(11, 22)}

    def test_remove_flagged_edges(self):
        """Mirror of reference remove_flagged_edges
        (ntjoin_utils.py:58-62): prunes listed edges into a copy."""
        from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
        from ntjoin_tpu.graph.mingraph import build_graph, remove_flagged_edges

        def asm(name, weight, hashes):
            return AssemblySketch.from_stream(
                name, weight, ["c"],
                np.array(hashes, dtype=np.uint64),
                np.arange(len(hashes), dtype=np.int64) * 100,
                np.zeros(len(hashes), dtype=np.int32),
            )

        shared = SharedIndex(
            [asm("a", 2.0, [5, 6, 7, 8]), asm("b", 1.0, [5, 6, 7, 8])]
        )
        g = build_graph(shared)
        assert g.num_edges == 3
        g2 = remove_flagged_edges(g, [1])
        assert g2.num_edges == 2 and g.num_edges == 3  # copy semantics


class TestBloom:
    def test_repeat_filter_hook(self, tmp_path):
        from ntjoin_tpu.core.assembly import AssemblySketch
        from ntjoin_tpu.utils.bloom import BloomFilter

        bf = BloomFilter(1 << 12)
        bf.insert("AAAA")
        tsv = tmp_path / "x.fa.k4.w2.tsv"
        tsv.write_text("c1\t10:0:AAAA 20:5:CCCC 30:9:GGGG\n")
        sk = AssemblySketch.from_tsv(str(tsv), 1.0, repeat_filter=bf)
        assert sk.hash.tolist() == [20, 30]
        sk2 = AssemblySketch.from_tsv(str(tsv), 1.0)
        assert len(sk2.hash) == 3

    def test_deterministic_across_processes(self, tmp_path):
        """ntHash-based indices: identical regardless of PYTHONHASHSEED
        (Python hash() is salted per process; btllib BFs are files shared
        across runs, so index determinism is required)."""
        code = (
            "from ntjoin_tpu.utils.bloom import BloomFilter\n"
            "print(list(BloomFilter(1 << 16)._indices('ACGTACGTACGTACG')))\n"
        )
        outs = set()
        for seed in ("0", "12345"):
            env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=seed)
            res = subprocess.run(
                [sys.executable, "-c", code], env=env,
                capture_output=True, text=True,
            )
            assert res.returncode == 0, res.stderr
            outs.add(res.stdout.strip())
        assert len(outs) == 1, outs

    def test_save_load_roundtrip(self, tmp_path):
        from ntjoin_tpu.utils.bloom import BloomFilter

        bf = BloomFilter(1 << 14, num_hashes=4)
        kmers = ["ACGTACGTAC", "TTTTTTTTTT", "GGGGCCCCAA"]
        for km in kmers:
            bf.insert(km)
        path = str(tmp_path / "repeats.bf")
        bf.save(path)
        bf2 = BloomFilter.load(path)
        assert bf2.size == bf.size and bf2.num_hashes == 4
        assert all(bf2.contains(km) for km in kmers)
        assert not bf2.contains("ACACACACAC")
        with pytest.raises(ValueError):
            (tmp_path / "junk.bf").write_bytes(b"nope")
            BloomFilter.load(str(tmp_path / "junk.bf"))


def test_run_argparse_smoke(tmp_path):
    """The argparse stage front-end runs the f-f case directly on TSVs."""
    import shutil

    for f in ["ref.fa", "scaf.f-f.fa"]:
        shutil.copy(f"/root/reference/tests/{f}", tmp_path / f)
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
         "backend=numpy", "target=scaf.f-f.fa", "references=ref.fa",
         "reference_weights=2", "k=32", "w=1000", "prefix=pre", "overlap=False"],
        cwd=tmp_path, env=env, check=True, capture_output=True,
    )
    # now drive the python stage directly over the produced TSVs
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu.run",
         "-s", "scaf.f-f.fa.k32.w1000.tsv", "-r", "2", "-k", "32", "-n", "2",
         "-p", "direct", "ref.fa.k32.w1000.tsv"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in (tmp_path / "direct.path").read_text().splitlines()
             if ln.startswith("ntJoin")]
    assert lines == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def test_many_contigs_overlap_e2e(tmp_path):
    """Synthetic many-contig fixture with overlap trimming on (the intent of
    the reference's test_more_sequences, whose big fixture is an absent blob)."""
    rng = np.random.default_rng(12345)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=60_000))
    (tmp_path / "ref.fa").write_text(f">genome\n{genome}\n")
    pieces = []
    bounds = list(range(0, 60_000, 5000))
    for i, b in enumerate(bounds):
        end = min(60_000, b + 5000 + 40)  # 40 bp overlap into the next piece
        pieces.append(f">piece{i}\n{genome[b:end]}\n")
    (tmp_path / "target.fa").write_text("".join(pieces))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
         "backend=numpy", "target=target.fa", "references=ref.fa",
         "reference_weights=2", "k=32", "w=250", "n=2", "prefix=many",
         "overlap=True"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr + res.stdout
    lines = [ln for ln in (tmp_path / "many.path").read_text().splitlines()
             if ln.startswith("ntJoin")]
    assert len(lines) == 1
    # all 12 pieces joined in order
    assert lines[0].count("piece") == 12
    assert (tmp_path / "target.fa.k32.w250.n2.all.scaffolds.fa").exists()


def test_mann_kendall_batch_matches_scalar():
    import jax.numpy as jnp

    from ntjoin_tpu.ops.mannkendall import mann_kendall_batch

    rows = [
        [12, 15, 14, 18, 21, 19, 25, 28, 26, 30, 33, 31],
        [31, 33, 30, 26, 28, 25, 19, 21, 18, 14, 15, 12],
        [5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5],
        [1, 9, 2, 8, 3, 7, 4, 6, 5, 5, 6, 4],
    ]
    L = 12
    pos = jnp.asarray(np.array(rows, dtype=np.int32))
    lengths = jnp.asarray(np.full(len(rows), L, dtype=np.int32))
    trend, h, p, z = mann_kendall_batch(pos, lengths)
    for i, row in enumerate(rows):
        t_ref, h_ref, p_ref, z_ref = mann_kendall(row)
        assert bool(np.asarray(h)[i]) == h_ref
        assert abs(float(np.asarray(p)[i]) - p_ref) < 1e-5
        assert abs(float(np.asarray(z)[i]) - z_ref) < 1e-4
        expect = {"increasing": 1, "decreasing": -1, "no trend": 0}[t_ref]
        assert int(np.asarray(trend)[i]) == expect

    # padding must not affect results
    pos2 = jnp.pad(pos, ((0, 0), (0, 5)), constant_values=777)
    trend2, h2, p2, _ = mann_kendall_batch(pos2, lengths)
    assert np.allclose(np.asarray(p), np.asarray(p2))


def _write_more_sequences_fixture(tmp_path):
    """Deterministic 24-contig fixture in the spirit of the reference's
    test_more_sequences (20-contig ``scaf.longer.fa``, a missing blob in
    the snapshot; reference ``tests/ntjoin_test.py:222-225``): many joined
    pieces with mixed orientation, two unassigned contigs and terminal Ns,
    stressing the unassigned BED complement path the pybedtools regression
    guarded."""
    rng = np.random.default_rng(777)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=120_000))
    (tmp_path / "ref.fa").write_text(f">genome\n{genome}\n")
    rc = str.maketrans("ACGT", "TGCA")
    pieces = []
    for i, b in enumerate(range(0, 120_000, 5000)):
        seg = genome[b : b + 5000]
        if i % 4 == 3:
            seg = seg[::-1].translate(rc)  # reverse-orient every 4th piece
        if i == 5:
            seg = "N" * 12 + seg[12:]  # terminal N stripping case
        pieces.append(f">piece{i}\n{seg}\n")
    # unrelated contigs: must come out unassigned, in BED and FASTA
    extra = "".join("ACGT"[i] for i in rng.integers(0, 4, size=3000))
    pieces.append(f">floating1\n{extra}\n")
    pieces.append(f">floating2\n{extra[::-1].translate(rc)}\n")
    (tmp_path / "target.fa").write_text("".join(pieces))


def test_more_sequences_golden(tmp_path):
    """24-contig run pinned to committed golden artifacts."""
    _write_more_sequences_fixture(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
         "backend=numpy", "target=target.fa", "references=ref.fa",
         "reference_weights=2", "k=32", "w=250", "n=2", "prefix=longer",
         "overlap=True", "agp=True"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr + res.stdout
    golden = os.path.join(REPO, "tests", "golden")
    for name, got in (
        ("longer.path", "longer.path"),
        ("longer.agp", "longer.agp"),
        ("longer.unassigned.bed",
         "longer.target.fa.k32.w250.tsv.unassigned.bed"),
    ):
        want = open(os.path.join(golden, name)).read()
        assert (tmp_path / got).read_text() == want, f"{name} differs"
    unassigned = (
        tmp_path / "target.fa.k32.w250.n2.unassigned.scaffolds.fa"
    ).read_text()
    assert ">floating1" in unassigned and ">floating2" in unassigned


def test_determine_orientations_batch_matches_scalar():
    """The batched orientation path (device integer-S MK + host f64 tail)
    gives verdicts identical to per-run determine_orientation, with and
    without --mkt (VERDICT round 2: wire ops/mannkendall into the
    pipeline)."""
    from ntjoin_tpu.core.orientation import (
        determine_orientation,
        determine_orientations,
    )

    rng = np.random.default_rng(11)
    runs = [
        [5],  # too short -> '?'
        list(range(0, 50, 3)),  # strictly increasing
        list(range(50, 0, -3)),  # strictly decreasing
        np.cumsum(rng.integers(-2, 5, size=40)).tolist(),  # noisy up
        np.cumsum(rng.integers(-4, 2, size=40)).tolist(),  # noisy down
        rng.integers(0, 100, size=30).tolist(),  # no trend
        [3, 3, 3, 3, 3, 3],  # all ties
    ]
    for use_mkt in (False, True):
        got = determine_orientations(runs, use_mkt, 90.0)
        want = [determine_orientation(r, use_mkt, 90.0) for r in runs]
        assert got == want, (use_mkt, got, want)


def test_mann_kendall_vectorized_long_run_parity():
    """The blocked-NumPy long-run path (n > 128) is bit-identical to the
    reference-semantics pair loop (pymannkendall original_test numerics)."""
    rng = np.random.default_rng(77)

    def mk_loop(positions, alpha=0.05):
        n = len(positions)
        s = 0
        for i in range(n - 1):
            for j in range(i + 1, n):
                d = positions[j] - positions[i]
                s += (d > 0) - (d < 0)
        counts = {}
        for x in positions:
            counts[x] = counts.get(x, 0) + 1
        tie = sum(t * (t - 1) * (2 * t + 5) for t in counts.values())
        var_s = (n * (n - 1) * (2 * n + 5) - tie) / 18.0
        if s > 0:
            z = (s - 1) / math.sqrt(var_s)
        elif s < 0:
            z = (s + 1) / math.sqrt(var_s)
        else:
            z = 0.0
        return s, tie, z

    for trial in range(3):
        # noisy increasing trend with repeats (ties exercise the correction)
        pos = np.cumsum(rng.integers(-2, 5, size=400)).tolist()
        trend, h, p, z = mann_kendall(pos)
        _, _, z_ref = mk_loop(pos)
        assert z == z_ref


def test_cli_gzip_artifact_rule(tmp_path):
    """gzip=True replaces the scaffold FASTAs with .gz files whose content
    round-trips (mirror of the reference's %.fa.gz rule, ntJoin:109-114)."""
    import gzip as gz

    rng = np.random.default_rng(5)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=20_000))
    (tmp_path / "ref.fa").write_text(f">g\n{genome}\n")
    (tmp_path / "target.fa").write_text(
        f">a\n{genome[:10030]}\n>b\n{genome[10000:]}\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
         "backend=numpy", "target=target.fa", "references=ref.fa",
         "reference_weights=2", "k=32", "w=250", "n=2", "prefix=gzt",
         "overlap=False", "gzip=True"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr + res.stdout
    base = tmp_path / "target.fa.k32.w250.n2"
    for kind in ("assigned", "unassigned", "all"):
        plain = tmp_path / f"target.fa.k32.w250.n2.{kind}.scaffolds.fa"
        packed = tmp_path / f"target.fa.k32.w250.n2.{kind}.scaffolds.fa.gz"
        assert packed.exists(), kind
        assert not plain.exists(), kind
    with gz.open(str(base) + ".all.scaffolds.fa.gz", "rt") as fh:
        body = fh.read()
    assert body.startswith(">")
    assert genome[:200] in body  # content survived the compression round-trip


def test_find_paths_scales_past_pool_territory():
    """The vectorized escalation + native chain walk handles a component
    count where the reference needed its multiprocessing pool
    (ntjoin.py:164-176): 50K components, each with a branch edge the
    escalating filter must remove, in one lockstep pass."""
    import time
    from types import SimpleNamespace

    from ntjoin_tpu.graph.mingraph import MinimizerGraph
    from ntjoin_tpu.graph.paths import find_paths

    ncomp = 50_000
    nodes_per = 5  # a-b-c-d chain + branch node e hanging off c
    num_nodes = ncomp * nodes_per
    base = np.arange(ncomp, dtype=np.int64) * nodes_per
    src = np.concatenate([base, base + 1, base + 2, base + 2])
    dst = np.concatenate([base + 1, base + 2, base + 3, base + 4])
    weight = np.concatenate([
        np.full(ncomp, 2.0), np.full(ncomp, 2.0), np.full(ncomp, 2.0),
        np.full(ncomp, 1.0),  # the weak branch edge
    ])
    support = np.ones(src.shape[0], dtype=np.int64)
    graph = MinimizerGraph(num_nodes, src.astype(np.int64),
                           dst.astype(np.int64), weight, support)
    shared = SimpleNamespace(
        assemblies=[SimpleNamespace(weight=2.0)],
        pos=np.arange(num_nodes, dtype=np.int64)[None, :],
    )
    t0 = time.monotonic()
    paths, total = find_paths(graph, shared, n_min=2.0)
    wall = time.monotonic() - t0
    assert total == ncomp
    assert len(paths) == ncomp
    first, _ = paths[0]
    assert first == [0, 1, 2, 3]
    last, _ = paths[-1]
    assert last == [(ncomp - 1) * nodes_per + i for i in range(4)]
    # the reference forked a pool for this; lockstep must stay sane single-
    # process (generous CI bound — measured ~2 s on the 2-CPU container)
    assert wall < 60.0


def test_auto_backend_routing_policy(monkeypatch, tmp_path):
    """backend=auto takes the GPU kernels only when JAX's default backend
    is a GPU and the job reaches the measured threshold of bases in short
    records; otherwise the native sketcher (in process, no probe)."""
    import jax

    from ntjoin_tpu import cli

    big = cli._AUTO_MIN_SHORT_BASES
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cli._sketch_backend("auto", short_bases=big).__name__ == (
        "sketch_codes_gpu"
    )
    be = cli._sketch_backend("auto", short_bases=big - 1)
    assert be.__name__ == "sketch_codes_native"
    assert cli._sketch_backend("auto").__name__ == "sketch_codes_native"
    # no GPU: host, whatever the job
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    be = cli._sketch_backend("auto", short_bases=10**10)
    assert be.__name__ == "sketch_codes_native"
    assert not cli._is_device_sketch(be)
    assert cli._is_device_sketch(cli._sketch_backend("jax"))


@pytest.mark.parametrize("cores,short", [(1, 0), (2, 6_000), (16, 6_000 + 40_000)])
def test_short_record_bases_follow_the_native_threading(
    monkeypatch, tmp_path, cores, short
):
    """Short records are those the native sketcher runs on one thread:
    fewer than 4096 windows per core.  Their bases come from the .fai
    indexes; a gzipped input counts none."""
    from ntjoin_tpu import cli
    from ntjoin_tpu.io.fasta import write_fai

    monkeypatch.setattr(cli.os, "cpu_count", lambda: cores)
    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    a.write_text(">s\n" + "A" * 6_000 + "\n>m\n" + "C" * 40_000 + "\n")
    b.write_text(">l\n" + "G" * 70_000 + "\n")
    gz = tmp_path / "c.fa.gz"
    gz.write_bytes(b"")
    for f in (a, b):
        write_fai(str(f))
    paths = [str(a), str(b), str(gz)]
    assert cli._short_record_bases(paths, k=32, w=1000) == short


def test_explicit_gpu_backend_never_becomes_host(monkeypatch):
    """backend=pallas without a GPU is an error, not a quiet host run."""
    import jax

    from ntjoin_tpu import cli

    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(SystemExit, match="needs a GPU"):
        cli._sketch_backend("pallas", short_bases=10**10)
    with pytest.raises(SystemExit, match="unknown backend"):
        cli._sketch_backend("bogus")


def test_host_routing_does_not_import_jax():
    """A job below the threshold routes to the host without importing
    JAX (host-only runs stay light)."""
    import subprocess
    import sys

    code = (
        "import sys; from ntjoin_tpu import cli; "
        "be = cli._sketch_backend('auto', short_bases=1000); "
        "print(be.__name__, 'jax' in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=os.path.dirname(os.path.dirname(__file__)),
    ).stdout.split()
    assert out == ["sketch_codes_native", "False"]


def test_cli_reports_backends_on_stderr(tmp_path, monkeypatch, capsys):
    """assemble prints one stderr line naming the sketch and index
    backends and the device they ran on."""
    from ntjoin_tpu import cli

    rng = np.random.default_rng(4)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
    (tmp_path / "ref.fa").write_text(">r\n" + seq + "\n")
    (tmp_path / "t.fa").write_text(">a\n" + seq[:3000] + "\n>b\n" + seq[3000:] + "\n")
    monkeypatch.chdir(tmp_path)
    args = ["target=t.fa", "references=ref.fa", "reference_weights=2",
            "k=15", "w=10", "overlap=False"]
    assert cli.assemble(["backend=numpy", *args]) == 0
    err = capsys.readouterr().err
    assert "ntjoin: sketch=numpy index=host device=host" in err
    assert cli.assemble(["-B", "backend=numpy", "index_backend=device", *args]) == 0
    err = capsys.readouterr().err
    assert "ntjoin: sketch=numpy index=device device=cpu" in err


class TestIncrementalGraphIdSpaces:
    """Round-5 review: base and fresh graphs may index DIFFERENT shared
    hash universes; extend_graph must translate through hashes."""

    @staticmethod
    def _asm(name, weight, hashes):
        from ntjoin_tpu.core.assembly import AssemblySketch

        return AssemblySketch.from_stream(
            name, weight, ["c"],
            np.array(hashes, dtype=np.uint64),
            np.arange(len(hashes), dtype=np.int64) * 100,
            np.zeros(len(hashes), dtype=np.int32),
        )

    def _pairs(self, g):
        nh = g.node_hash
        return {
            tuple(sorted((int(nh[s]), int(nh[t]))))
            for s, t in zip(g.src[g.alive], g.dst[g.alive])
        }

    def test_extend_with_shifted_id_space(self):
        """New hashes sorting BELOW the base universe shift every id;
        edges must still dedupe/merge by hash identity."""
        from ntjoin_tpu.core.assembly import SharedIndex
        from ntjoin_tpu.graph.mingraph import build_graph, extend_graph

        base_shared = SharedIndex(
            [self._asm("a", 2.0, [20, 30]), self._asm("b", 1.0, [20, 30])]
        )
        g1 = build_graph(base_shared)
        assert self._pairs(g1) == {(20, 30)}
        # 10 sorts below everything: fresh ids are shifted by one
        ext = SharedIndex(
            [self._asm("a", 2.0, [10, 20, 30]),
             self._asm("b", 1.0, [10, 20, 30])]
        )
        g2 = extend_graph(g1, ext)
        # 20-30 kept from base (not duplicated), 10-20 added
        assert self._pairs(g2) == {(10, 20), (20, 30)}
        assert g2.num_edges == 2

        # blacklisted NEW minimizer 10: its edge is pruned even though
        # its fresh id (0) aliases base id 0 (= hash 20)
        g3 = extend_graph(g1, ext, black_list=[10])
        assert self._pairs(g3) == {(20, 30)}

        # blacklisted but ALREADY a base-universe vertex: exempt
        g4 = extend_graph(g1, ext, black_list=[20])
        assert self._pairs(g4) == {(10, 20), (20, 30)}

    def test_removed_edge_is_readdable(self):
        """A pair pruned via remove_flagged_edges must be re-addable by a
        later extend (the reference physically deletes edges, so its
        incremental build re-adds them)."""
        from ntjoin_tpu.core.assembly import SharedIndex
        from ntjoin_tpu.graph.mingraph import (
            build_graph, extend_graph, remove_flagged_edges,
        )

        shared = SharedIndex(
            [self._asm("a", 2.0, [5, 6, 7]), self._asm("b", 1.0, [5, 6, 7])]
        )
        g = build_graph(shared)
        assert g.num_edges == 2
        g2 = remove_flagged_edges(g, [0])
        assert g2.num_edges == 1
        g3 = extend_graph(g2, shared)
        assert self._pairs(g3) == {(5, 6), (6, 7)}
