"""Synthetic-scale end-to-end profiling harness.

Generates a random genome as the reference assembly, a fragmented +
lightly-shuffled copy as the target draft, then runs the full assemble
pipeline (host backend) under an optional cProfile, reporting per-stage
wall times.  Mirrors the scale methodology recorded in CLAUDE.md
("Measured scale point").

Usage:
    python scripts/perf_scale.py --mbp 100 [--refs N] [--backend B] [--profile] [--keep DIR]

``--refs N`` scaffolds against N synthetic references (each an independent
shuffle of the genome) so the cross-assembly intersection and edge-support
stages scale like a real multi-reference run; the default is 1.
``--backend`` picks the sketch path (auto|native|numpy|jax|pallas).
"""
from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int8)


CODES = np.frombuffer(b"ACGTN", dtype=np.uint8)  # code 4: N


def write_fasta(path: str, records: list[tuple[str, np.ndarray]]) -> None:
    """FASTA with 80-base lines, each record's full lines written as one
    (lines, 81) block."""
    with open(path, "wb") as fh:
        for name, codes in records:
            fh.write(b">" + name.encode() + b"\n")
            full = codes.shape[0] // 80
            block = np.empty((full, 81), np.uint8)
            block[:, :80] = CODES[codes[: full * 80]].reshape(full, 80)
            block[:, 80] = ord("\n")
            fh.write(block.tobytes())
            if codes.shape[0] % 80:
                fh.write(CODES[codes[full * 80 :]].tobytes() + b"\n")


def make_inputs(workdir: str, mbp: float, seed: int = 7, n_refs: int = 1):
    rng = np.random.default_rng(seed)
    n = int(mbp * 1e6)
    genome = synth_genome(rng, n)
    # references: a few chromosome-scale sequences each; extra references
    # use offset chromosome boundaries so they are distinct assemblies of
    # the same underlying genome (the multi-reference BASELINE config)
    n_chrom = max(1, int(round(mbp / 50)))
    ref_fas = []
    for r in range(n_refs):
        off = (r * n) // (n_chrom * max(1, n_refs) * 2)
        bounds = np.linspace(0, n, n_chrom + 1).astype(np.int64)
        bounds[1:-1] = np.clip(bounds[1:-1] + off, 1, n - 1)
        ref = [
            (f"r{r}chr{i}", genome[bounds[i] : bounds[i + 1]])
            for i in range(n_chrom)
        ]
        ref_fa = os.path.join(workdir, f"ref{r if r else ''}.fa")
        write_fasta(ref_fa, ref)
        ref_fas.append(ref_fa)
    # target: fragmented into ~50 kbp contigs, order shuffled, some reversed
    frag = 50_000
    cuts = np.arange(0, n, frag)
    cuts = np.append(cuts, n)
    pieces = []
    comp = np.array([3, 2, 1, 0], dtype=np.int8)
    for i in range(cuts.shape[0] - 1):
        codes = genome[cuts[i] : cuts[i + 1]]
        if rng.random() < 0.3:
            codes = comp[codes[::-1]]
        pieces.append((f"ctg{i}", codes))
    order = rng.permutation(len(pieces))
    tgt = [pieces[i] for i in order]
    tgt_fa = os.path.join(workdir, "target.fa")
    write_fasta(tgt_fa, tgt)
    return ref_fas, tgt_fa


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=100.0)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--w", type=int, default=1000)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--keep", default=None, help="keep workdir at this path")
    ap.add_argument("--sort", default="cumulative")
    ap.add_argument("--backend", default="auto", help="sketch backend")
    ap.add_argument("--refs", type=int, default=1, help="number of references")
    args = ap.parse_args()
    if args.refs < 1:
        ap.error("--refs must be >= 1 (at least one reference assembly)")

    workdir = args.keep or tempfile.mkdtemp(prefix="ntjoin_scale_")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    # generate inputs in a CHILD process: at Gbp scale the generator holds
    # several GB transiently, which would otherwise pollute this process's
    # ru_maxrss — the number we report for the assemble run itself
    import subprocess

    gen = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, {!r}); "
         "from perf_scale import make_inputs; "
         "make_inputs({!r}, {}, n_refs={})".format(
             os.path.dirname(os.path.abspath(__file__)),
             workdir, args.mbp, args.refs,
         )],
    )
    if gen.returncode != 0:
        return 1
    ref_fas = [
        os.path.join(workdir, f"ref{r if r else ''}.fa")
        for r in range(args.refs)
    ]
    tgt_fa = os.path.join(workdir, "target.fa")
    print(f"[inputs] {args.mbp} Mbp generated in {time.perf_counter()-t0:.1f}s")

    from ntjoin_tpu import cli

    # The artifact-naming contract (prefix + "." + target-TSV-name) assumes
    # relative paths from the working directory, like the reference Makefile.
    os.chdir(workdir)
    words = [
        "assemble",
        f"target={os.path.basename(tgt_fa)}",
        "references=" + " ".join(os.path.basename(r) for r in ref_fas),
        "reference_weights=" + " ".join("2" for _ in ref_fas),
        f"k={args.k}",
        f"w={args.w}",
        "prefix=out",
        "time=True",
        f"backend={args.backend}",
    ]
    t0 = time.perf_counter()
    if args.profile:
        prof = cProfile.Profile()
        prof.enable()
        rc = cli.main(words)
        prof.disable()
        stats = pstats.Stats(prof)
        stats.sort_stats(args.sort).print_stats(35)
    else:
        rc = cli.main(words)
    e2e_s = time.perf_counter() - t0
    print(f"[e2e] assemble rc={rc} in {e2e_s:.1f}s")
    rss_gb = None
    try:
        import resource

        rss_gb = round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2
        )
    except Exception:
        pass
    # stage breakdown from the time=True artifacts (wall + peak RSS at the
    # end of each stage — the BENCH detail for the human-scale north star)
    import glob
    import json

    stages = {}
    for tf in glob.glob("out.*.time"):
        try:
            kv = dict(
                line.split("\t")
                for line in open(tf, encoding="utf-8").read().splitlines()
            )
            stages[kv["stage"]] = {
                "wall_s": round(float(kv["wall_s"]), 1),
                "rss_gb": round(int(kv["peak_rss_kb"]) / 1e6, 2),
            }
        except (OSError, KeyError, ValueError):
            pass

    print(json.dumps({
        "mbp": args.mbp, "refs": args.refs, "backend": args.backend,
        "e2e_s": round(e2e_s, 1), "rss_gb": rss_gb, "rc": rc,
        "stages": stages,
    }))
    if not args.keep:
        shutil.rmtree(workdir, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
