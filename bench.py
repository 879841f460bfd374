"""Benchmark: GPU minimizer sketch throughput + end-to-end scaffolding wall.

FINAL stdout line is the compact headline:
  {"metric": ..., "value": N, "unit": "Gbp/s", "vs_baseline": N, "device": {...}}
The full detail dict is printed on the line before it.

Headline metric: sketch throughput of the GPU path (``ops/sketch_gpu``:
2-bit upload, hash and window kernels, emission compaction, result fetch)
on one clean 2^27-base record at k=32, w=1000, median of 5 after warm-up.
``vs_baseline`` compares against the native C++ rolling sketcher.

The device measurements run in one child process (one process per card);
the end-to-end cells run after it has exited.  Without a GPU the benchmark
fails: it never reports a host number under a device name.
"""
import json
import os
import statistics
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

import numpy as np

_DEVICE_BODY = """
import json, statistics, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import jax
from ntjoin_tpu.io.native import sketch_codes_native
from ntjoin_tpu.ops.sketch_gpu import sketch_records_gpu

d = jax.devices()
if d[0].platform != "gpu":
    sys.exit("no GPU: JAX runs on " + d[0].platform)
size = {size}
k, w = 32, 1000
rng = np.random.default_rng(42)

# bit-exactness gate: the product path vs the native sketcher
par_clean = rng.integers(0, 4, size=16_777_216).astype(np.uint8)
par_clean[2_000_000:2_001_500] = 1  # repeat run
par_n = rng.integers(0, 4, size=12_000_000).astype(np.uint8)
par_n[100_000:100_400] = 4  # N runs: segmentation and junction patches
par_n[7_000_000:7_000_050] = 4
for got, rec in zip(sketch_records_gpu([par_clean, par_n], k, w), (par_clean, par_n)):
    ref = sketch_codes_native(rec, k, w)
    assert np.array_equal(got.positions, ref.positions), "parity"
    assert np.array_equal(got.hashes, ref.hashes), "parity"

def median_s(fn, n=5):
    fn()  # warm-up: compile + first touch
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)

codes = rng.integers(0, 4, size=size).astype(np.uint8)
recs = [codes[i:i + 2_000_000] for i in range(0, size, 2_000_000)]
codes_n = codes.copy()
for s in rng.integers(0, size - 600, 100):
    codes_n[s:s + 500] = 4
recs_n = [codes_n[i:i + 2_000_000] for i in range(0, size, 2_000_000)]
print(json.dumps({{
    "device": {{"platform": d[0].platform, "kind": d[0].device_kind,
                "count": len(d)}},
    "single_s": median_s(lambda: sketch_records_gpu([codes], k, w)),
    "multi_s": median_s(lambda: sketch_records_gpu(recs, k, w)),
    "n_rich_s": median_s(lambda: sketch_records_gpu(recs_n, k, w)),
}}))
"""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def run_device(size: int) -> dict:
    res = subprocess.run(
        [sys.executable, "-c", _DEVICE_BODY.format(repo=_REPO, size=size)],
        capture_output=True, text=True, timeout=1800,
    )
    if res.returncode != 0:
        sys.stderr.write(res.stderr)
        raise SystemExit(f"device measurement failed (exit {res.returncode})")
    return json.loads(res.stdout.strip().splitlines()[-1])


def bench_host_native(codes_np, k, w, n=3):
    from ntjoin_tpu.io.native import sketch_codes_native

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        sketch_codes_native(codes_np, k, w)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def bench_e2e(size_mbp: int, backend: str) -> float:
    """Synthetic end-to-end scaffolding wall: one reference genome, target
    split into oriented 50 kbp contigs, full CLI run to artifacts."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="ntjoin_bench_")
    try:
        n = size_mbp * 1_000_000
        rng = np.random.default_rng(7)
        genome = (
            np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=n)]
            .tobytes()
            .decode()
        )
        rc = str.maketrans("ACGT", "TGCA")
        with open(os.path.join(workdir, "ref.fa"), "w") as f:
            for i in range(0, n, 5_000_000):
                f.write(f">r{i}\n{genome[i:i + 5_000_000]}\n")
        with open(os.path.join(workdir, "target.fa"), "w") as f:
            for j, i in enumerate(range(0, n, 50_000)):
                seg = genome[i : i + 50_000]
                if j % 3 == 2:
                    seg = seg[::-1].translate(rc)
                f.write(f">t{j}\n{seg}\n")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "ntjoin_tpu.cli", "assemble",
             f"backend={backend}", "target=target.fa", "references=ref.fa",
             "reference_weights=2", "prefix=bench", "k=32", "w=1000", "n=2",
             "overlap=False"],
            cwd=workdir, check=True, capture_output=True, timeout=1800,
            env=dict(os.environ, PYTHONPATH=_REPO),
        )
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def bench_scale(mbp: int, refs: int = 2, timeout: float = 3600) -> dict:
    """Synthetic-scale end-to-end run via scripts/perf_scale.py (native
    sketch, host index); mbp=3000 is BASELINE config 5 (~3 Gbp draft + 2
    references)."""
    res = subprocess.run(
        [sys.executable, os.path.join(_REPO, "scripts", "perf_scale.py"),
         "--mbp", str(mbp), "--refs", str(refs), "--backend", "native"],
        capture_output=True, text=True, timeout=timeout, check=True,
        env=dict(os.environ, PYTHONPATH=_REPO),
    )
    for line in res.stdout.splitlines():
        if line.startswith("{") and '"e2e_s"' in line:
            return json.loads(line)
    return {}


def main():
    k, w = 32, 1000
    size = 1 << 27  # 134 Mbp
    card_line = card()
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, size=1 << 24).astype(np.uint8)
    baseline_bps = codes.shape[0] / bench_host_native(codes, k, w)

    dev = run_device(size)
    detail = {
        "k": k, "w": w, "bases": size, "card": card_line,
        "device": dev["device"],
        "baseline": "native C++ rolling sketcher",
        "baseline_gbps": round(baseline_bps / 1e9, 4),
        "single_record_ms": round(dev["single_s"] * 1e3, 1),
        "multi_record_gbps": round(size / dev["multi_s"] / 1e9, 4),
        "n_rich_gbps": round(size / dev["n_rich_s"] / 1e9, 4),
    }
    main_bps = size / dev["single_s"]
    e2e = sorted(bench_e2e(30, "native") for _ in range(3))
    detail["e2e_scaffold_30mbp_native_s"] = round(e2e[1], 2)
    detail["e2e_scaffold_30mbp_auto_s"] = round(bench_e2e(30, "auto"), 2)
    detail["e2e_scaffold_30mbp_pallas_s"] = round(bench_e2e(30, "pallas"), 2)
    scale = bench_scale(1000)
    detail["e2e_scaffold_1gbp_wall_s"] = round(scale.get("e2e_s", -1), 1)
    detail["e2e_scaffold_1gbp_rss_gb"] = scale.get("rss_gb")
    if not os.environ.get("BENCH_SKIP_3GBP"):
        scale3 = bench_scale(3000, timeout=2700)
        detail["e2e_scaffold_3gbp_wall_s"] = round(scale3.get("e2e_s", -1), 1)
        detail["e2e_scaffold_3gbp_rss_gb"] = scale3.get("rss_gb")
        detail["e2e_scaffold_3gbp_stages"] = scale3.get("stages", {})

    headline = {
        "metric": "minimizer_sketch_throughput",
        "value": round(main_bps / 1e9, 4),
        "unit": "Gbp/s",
        "vs_baseline": round(main_bps / baseline_bps, 2),
        "device": dev["device"],
    }
    print(json.dumps({"detail": detail}))
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
