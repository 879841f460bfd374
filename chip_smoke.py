#!/usr/bin/env python3
"""Smoke run of ntjoin-tpu on the GPU: kernels at real widths, then the
``assemble`` CLI end to end on a plant-genome-scale job.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # four cards of one host

One card: prints the card (``nvidia-smi``) and JAX's devices; runs the
tests marked ``gpu``; checks the GPU sketch bit for bit against the native
sketcher and the device index passes against their host passes; runs
``assemble`` on a 2^27-base genome twice (native sketch + host index, then
``backend=pallas``) and requires the second run to take the GPU for both
stages, with no host route and every artifact byte-equal; prints where
``backend=auto`` routes this job and a job at the threshold; then times
the sketch kernels against what XLA makes of the plain sketch
(``ops/sketch_jax``).

``--four``: the same job as a one-card run, as four processes with one
card each (``coordinator=`` mode: each process sketches its records on
the host, the cards carry the all-to-all uniqueness verdict) and as one
process that sees all four cards (it drives the first), artifacts
byte-compared.

Without a GPU it exits non-zero and prints no result.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import filecmp
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

from ntjoin_tpu import cli  # noqa: E402
from ntjoin_tpu.utils import routes  # noqa: E402

K, W = 32, 1000
GENOME_BASES = 1 << 27  # Arabidopsis-sized draft
ASSEMBLE_ARGS = [
    "target=target.fa", "references=ref.fa ref1.fa", "reference_weights=2 2",
    "prefix=smoke", "k=32", "w=1000", "n=2", "overlap=True", "agp=True",
    "time=True",
]


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def median_time(fn, reps: int = 5) -> float:
    fn()  # warm-up: compile and first touch
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def same_sketch(a, b) -> bool:
    return (np.array_equal(a.positions, b.positions)
            and np.array_equal(a.hashes, b.hashes))


# -- phase 2: kernels and device passes at real widths -----------------------


def phase_gpu_tests() -> None:
    """The tests marked ``gpu``, in a child process that has the card to
    itself (this process has not touched JAX yet)."""
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", os.path.join(REPO, "tests")],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cuda"),
    )
    summary = res.stdout.strip().splitlines()[-1] if res.stdout else ""
    log(f"pytest -m gpu: {summary}")
    assert res.returncode == 0 and "skipped" not in summary, res.stdout[-3000:]


def phase_parity(rng, clean_bases=16_000_000, n_bases=12_000_000):
    from ntjoin_tpu.io.native import sketch_codes_native
    from ntjoin_tpu.ops.sketch_gpu import sketch_records_gpu

    clean = rng.integers(0, 4, size=clean_bases).astype(np.uint8)
    clean[2_000_000:2_001_500] = 1  # 1,500-base homopolymer run
    nrec = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    for s, ln in ((100_000, 400), (7_000_000, 50), (9_000_000, 5_000)):
        nrec[s:s + ln] = 4
    got = sketch_records_gpu([clean, nrec], K, W)
    for rec, sk in zip((clean, nrec), got):
        assert same_sketch(sk, sketch_codes_native(rec, K, W)), "sketch parity"
    log(f"parity: GPU sketch == native sketcher ({clean_bases} clean bases "
        f"with a repeat run, {n_bases} bases with N runs)")
    phase_index(rng, clean, got[0])


def phase_index(rng, genome, ref_sketch):
    """Shared index, graph, components and paths: device == host."""
    import copy

    from ntjoin_tpu.core.assembly import AssemblySketch, SharedIndex
    from ntjoin_tpu.graph.mingraph import build_graph
    from ntjoin_tpu.graph.paths import find_paths
    from ntjoin_tpu.ops.device_index import build_graph_device, shared_index_device
    from ntjoin_tpu.ops.sketch_gpu import sketch_records_gpu

    comp = np.array([3, 2, 1, 0], np.uint8)
    frags = [genome[i:i + 50_000] for i in range(0, genome.shape[0], 50_000)]
    frags = [comp[f[::-1]] if rng.random() < 0.3 else f for f in frags]
    order = rng.permutation(len(frags))
    frags = [frags[i] for i in order]
    sks = sketch_records_gpu(frags, K, W)
    ref = AssemblySketch.from_stream(
        "ref", 2.0, ["chr"], ref_sketch.hashes, ref_sketch.positions,
        np.zeros(ref_sketch.positions.shape[0], np.int32),
    )
    tgt = AssemblySketch.from_stream(
        "tgt", 1.0, [f"c{i}" for i in range(len(frags))],
        np.concatenate([s.hashes for s in sks]),
        np.concatenate([s.positions for s in sks]),
        np.concatenate([np.full(s.positions.shape[0], i, np.int32)
                        for i, s in enumerate(sks)]),
    )
    host = SharedIndex([ref, tgt])
    dev = shared_index_device([ref, tgt])
    assert np.array_equal(host.node_hash, dev.node_hash), "shared index"
    assert np.array_equal(host.pos, dev.pos) and np.array_equal(host.ctg, dev.ctg)
    gh, gd = build_graph(host), build_graph_device(dev)
    for f in ("src", "dst", "weight", "support_mask"):
        assert np.array_equal(getattr(gh, f), getattr(gd, f)), f"graph {f}"
    assert gd.use_device_cc
    assert np.array_equal(gh.components(), gd.components()), "components"
    hp, hn = find_paths(copy.deepcopy(gh), host, 2.0, device=False)
    dp, dn = find_paths(copy.deepcopy(gd), dev, 2.0, device=True)
    assert hn == dn and [p for p, _ in hp] == [p for p, _ in dp], "paths"
    log(f"parity: device index == host ({host.num_nodes} nodes, "
        f"{gh.src.shape[0]} edges, {hn} components, {len(hp)} paths)")


# -- phase 3: assemble end to end ---------------------------------------------


def make_job(work: str, rng, mbp: float) -> None:
    """Genome, 2 chromosome-scale references, ~50 kbp target contigs (30%
    reverse-complemented) with interior N runs in every fifth contig."""
    from perf_scale import make_inputs, write_fasta

    from ntjoin_tpu.io.fasta import read_fasta

    make_inputs(work, mbp, seed=11, n_refs=2)
    tgt = os.path.join(work, "target.fa")
    recs = []
    for i, rec in enumerate(read_fasta(tgt)):
        codes = rec.codes.astype(np.int8)
        if i % 5 == 0:
            for _ in range(int(rng.integers(1, 4))):
                ln = int(rng.integers(100, 5_001))
                s = int(rng.integers(1_000, max(1_001, codes.shape[0] - ln - 1_000)))
                codes[s:s + ln] = 4
        recs.append((rec.id, codes))
    write_fasta(tgt, recs)


def assemble_in(src: str, work: str, extra: list[str]) -> str:
    """Run the CLI in ``work`` on hard links of the inputs in ``src``;
    returns its stderr."""
    os.makedirs(work, exist_ok=True)
    for f in ("ref.fa", "ref1.fa", "target.fa"):
        os.link(os.path.join(src, f), os.path.join(work, f))
    err = io.StringIO()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            rc = cli.main(["assemble", "-B", *ASSEMBLE_ARGS, *extra])
            wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    sys.stderr.write(err.getvalue())
    assert rc == 0, f"assemble {extra} exited {rc}"
    log(f"assemble {' '.join(extra)}: {wall:.1f} s")
    return err.getvalue()


def artifacts(work: str) -> list[str]:
    """Every file a run wrote but its wall-time log (``time=True``)."""
    return sorted(
        f for f in os.listdir(work)
        if f not in ("ref.fa", "ref1.fa", "target.fa") and not f.endswith(".time")
    )


def compare_runs(a: str, b: str, names: list[str] | None = None) -> int:
    """Byte-compare ``names`` (default: every artifact, and the two sets
    must match) between two run directories."""
    if names is None:
        names = artifacts(a)
        assert names == artifacts(b), f"artifacts: {names} vs {artifacts(b)}"
    for f in names:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), (
            f"{f} differs"
        )
    return len(names)


def phase_e2e(root: str, rng, mbp: float) -> None:
    src = os.path.join(root, "inputs")
    os.makedirs(src)
    t0 = time.perf_counter()
    make_job(src, rng, mbp)
    log(f"inputs: {time.perf_counter() - t0:.1f} s")
    routes.reset()
    assemble_in(src, os.path.join(root, "host"),
                ["backend=native", "index_backend=host"])
    host = os.path.join(root, "host")
    short = cli._short_record_bases(
        [os.path.join(host, f) for f in ("ref.fa", "ref1.fa", "target.fa")], K, W
    )
    limit = cli._AUTO_MIN_SHORT_BASES
    auto = cli._sketch_backend("auto", short_bases=short).__name__
    big = cli._sketch_backend("auto", short_bases=limit).__name__
    log(f"backend=auto: {short} bases in short records -> {auto}; "
        f"{limit} (the threshold) -> {big}")
    assert big == "sketch_codes_gpu"
    routes.reset()
    err = assemble_in(src, os.path.join(root, "gpu"), ["backend=pallas"])
    chosen = [ln for ln in err.splitlines() if ln.startswith("ntjoin: sketch=")]
    log(*chosen)
    assert chosen and "sketch=pallas index=device device=gpu" in chosen[0], (
        "backend=pallas did not take the GPU for both stages"
    )
    log(f"host_routes={routes.host_routes()}")
    assert routes.host_routes() == 0
    n = compare_runs(os.path.join(root, "host"), os.path.join(root, "gpu"))
    log(f"artifacts byte-equal to the native/host run: {n}")


# -- phase 4: kernels vs the plain XLA sketch ---------------------------------


def phase_timing(rng, bases: int = 1 << 27) -> None:
    from ntjoin_tpu.ops.sketch_gpu import sketch_records_gpu
    from ntjoin_tpu.ops.sketch_jax import sketch_codes_jax

    codes = rng.integers(0, 4, size=bases).astype(np.uint8)
    recs = [codes[i:i + 2_000_000] for i in range(0, bases, 2_000_000)]
    codes_n = codes.copy()
    for s in rng.integers(0, bases - 600, 100):
        codes_n[s:s + 500] = 4
    recs_n = [codes_n[i:i + 2_000_000] for i in range(0, bases, 2_000_000)]
    cases = (("one clean record", [codes]), ("2 Mbp records", recs),
             ("2 Mbp records, 100 runs of 500 N", recs_n))
    for name, rl in cases:
        kern = sketch_records_gpu(rl, K, W)
        plain = [sketch_codes_jax(r, K, W) for r in rl]
        assert all(same_sketch(a, b) for a, b in zip(kern, plain)), name
        t_k = median_time(lambda rl=rl: sketch_records_gpu(rl, K, W))
        t_x = median_time(lambda rl=rl: [sketch_codes_jax(r, K, W) for r in rl])
        log(f"sketch {bases} bases, {name}: Pallas kernels {t_k * 1e3:.1f} ms, "
            f"XLA sketch_jax {t_x * 1e3:.1f} ms (median of 5)")


# -- four cards ---------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cli(work: str, extra: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
         *ASSEMBLE_ARGS, *extra],
        cwd=work, env=dict(os.environ, PYTHONPATH=REPO, **env),
    )


def four(root: str, rng, mbp: float) -> None:
    """One-card run, then four processes (one card each), in children; the
    run of one process that sees all four cards last, in this process."""
    src = os.path.join(root, "inputs")
    os.makedirs(src)
    make_job(src, rng, mbp)
    dirs = {}
    for name in ("one", "procs", "all"):
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name])
        for f in ("ref.fa", "ref1.fa", "target.fa"):
            os.link(os.path.join(src, f), os.path.join(dirs[name], f))
    t0 = time.perf_counter()
    one = run_cli(dirs["one"], ["backend=pallas"], {"CUDA_VISIBLE_DEVICES": "0"})
    assert one.wait() == 0, "one-card run"
    log(f"one card: {time.perf_counter() - t0:.1f} s")
    port = free_port()
    t0 = time.perf_counter()
    procs = [
        run_cli(dirs["procs"], [f"coordinator=localhost:{port}", "n_procs=4",
                                f"process_id={i}"], {})
        for i in range(4)
    ]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [0, 0, 0, 0], f"four processes: {rcs}"
    log(f"four processes: {time.perf_counter() - t0:.1f} s")
    n = compare_runs(dirs["one"], dirs["procs"], artifacts(dirs["procs"]))
    log(f"four processes == one card: {n} artifacts byte-equal")
    import jax

    assert len(jax.devices()) == 4, jax.devices()
    routes.reset()
    err = io.StringIO()
    cwd = os.getcwd()
    os.chdir(dirs["all"])
    try:
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            assert cli.main(["assemble", "-B", *ASSEMBLE_ARGS, "backend=pallas"]) == 0
    finally:
        os.chdir(cwd)
    sys.stderr.write(err.getvalue())
    log(f"one process, four cards visible: {time.perf_counter() - t0:.1f} s")
    assert "sketch=pallas index=device device=gpu" in err.getvalue()
    assert routes.host_routes() == 0
    n = compare_runs(dirs["one"], dirs["all"])
    log(f"one process, four cards visible == one card: {n} artifacts byte-equal")


def main(argv: list[str]) -> int:
    four_cards = argv == ["--four"]
    if argv and not four_cards:
        print(__doc__, file=sys.stderr)
        return 2
    log(card_line())
    rng = np.random.default_rng(2027)
    os.makedirs(os.path.join(REPO, ".smoke"), exist_ok=True)
    root = tempfile.mkdtemp(dir=os.path.join(REPO, ".smoke"))
    try:
        if four_cards:
            probe = subprocess.run(
                [sys.executable, "-c", "import jax; d = jax.devices(); "
                 "print(d[0].platform, len(d))"],
                capture_output=True, text=True, check=True,
            ).stdout.split()
            if probe != ["gpu", "4"]:
                print(f"need four GPUs, JAX has {probe}", file=sys.stderr)
                return 1
            four(root, rng, GENOME_BASES / 1e6)
        else:
            phase_gpu_tests()
            import jax

            t0 = time.perf_counter()
            devs = jax.devices()
            log(devs)
            if devs[0].platform != "gpu":
                print("no GPU: JAX runs on", devs[0].platform, file=sys.stderr)
                return 1
            log(f"device init: {time.perf_counter() - t0:.2f} s")
            phase_parity(rng)
            phase_e2e(root, rng, GENOME_BASES / 1e6)
            phase_timing(rng)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
