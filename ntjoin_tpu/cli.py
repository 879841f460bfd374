"""Command-line driver mirroring the reference's Make interface.

Accepts the same ``key=value`` word style as the reference Makefile
(``ntJoin:117-147``), including ``reference_config`` CSV files
(``ntJoin:17-23``), and reproduces its artifact flow: per-assembly minimizer
TSV + ``.fai`` (with Make-like timestamp reuse, ``ntJoin:204-208``), the
python scaffolding stage, and the assigned/unassigned/all scaffold FASTA
trio (``ntJoin:228-236``).

Usage::

    ntjoin-tpu assemble target=scaf.fa references='ref.fa' reference_weights='2' \
        k=32 w=1000 n=2 [prefix=...] [overlap=True] [agp=True] ...
    ntjoin-tpu analysis target=scaf.fa references='ref.fa' ref=truth.fa  # minimap2+samtools
    ntjoin-tpu quast target=scaf.fa references='ref.fa' ref=truth.fa [large=1]
"""
from __future__ import annotations

import os
import sys

from ntjoin_tpu.core.assembly import AssemblySketch
from ntjoin_tpu.core.config import ScaffoldConfig
from ntjoin_tpu.core.scaffolder import Scaffolder
from ntjoin_tpu.emit.writers import write_minimizer_tsv
from ntjoin_tpu.io.fasta import read_fasta, write_fai
from ntjoin_tpu.utils.timers import StageTimers

VERSION = "ntjoin-tpu 0.1.0 (capability parity target: ntJoin v1.1.5)"

_DEFAULTS = {
    "target": "None",
    "references": "None",
    "reference_config": "None",
    "reference_weights": "None",
    "target_weight": "1",
    "w": "1000",
    "k": "32",
    "overlap": "True",
    "overlap_w": "10",
    "overlap_k": "15",
    "t": "4",
    "assemble_t": "1",
    "n": "1",
    "g": "20",
    "overlap_g": "",
    "G": "0",
    "mkt": "False",
    "agp": "False",
    "m": "90",
    "no_cut": "False",
    "time": "False",
    "gzip": "False",
    "prefix": "",
    "backend": "auto",
    # filter/graph stage: host | device | auto (device iff the sketch
    # backend is a JAX one — data is then already device-resident)
    "index_backend": "auto",
    # multi-process distributed mode (parallel/pipeline.py): launch the
    # same command once per process with process_id=0..n_procs-1
    "coordinator": "None",
    "n_procs": "1",
    "process_id": "0",
    "local_devices": "None",
}


def _parse_vars(words: list[str]) -> dict[str, str]:
    out = dict(_DEFAULTS)
    for word in words:
        if "=" not in word:
            raise SystemExit(f"ERROR: unrecognized argument {word!r}")
        key, val = word.split("=", 1)
        out[key] = val
    return out


def _truthy(val: str) -> bool:
    return val.strip().lower() in ("true", "1", "yes")


# backend=auto takes the GPU when the job holds at least this many bases
# in short records: records the native sketcher runs on one thread (fewer
# than 4096 windows per core, nj_sketch_mt in native/ntjoin_native.cpp)
# and one record after another, while the GPU batches them.  Chromosome-
# scale records already use every core natively, and the GPU's start-up
# (~2 s for JAX and the card, ~4.5 s to trace, lower and load the first
# program) is not won back on them.  Measured end to end on an H100 (700
# W, 16 host cores, warm compile cache), native/host vs GPU:
#   - 512 Mbp genome, 2 chromosome-scale references, 10,240 target
#     contigs of 50 kbp, every fifth with N runs (512 Mbp short):
#     49.0 / 49.9 s vs 46.0 / 45.9 s;
#   - 3 Gbp genome, 1 reference, 60,000 contigs of 50 kbp (3 Gbp short):
#     247.1 s vs 180.0 s;
#   - 134 Mbp genome, 2 references, 2,685 contigs (134 Mbp short; the
#     chip_smoke.py job, on a 400 W card): 11.0 s vs 16.4 s;
#   - 1 Gbp genome, three chromosome-scale assemblies (none short):
#     66.3 s vs 72.3 s.
# The threshold sits just under the smallest measured win.
_AUTO_MIN_SHORT_BASES = 500_000_000

_SKETCH_NAMES = {
    "sketch_codes_gpu": "pallas",
    "sketch_codes_jax": "jax",
    "sketch_codes_native": "native",
    "sketch_codes": "numpy",
}


def _short_record_bases(fastas: list[str], k: int, w: int) -> int:
    """Bases in the records the native sketcher runs on one thread, read
    from the fresh ``.fai`` indexes.  A gzipped input has no index to read
    and counts none."""
    limit = 4096 * (os.cpu_count() or 1) + w + k - 2
    total = 0
    for fa in fastas:
        if fa.endswith(".gz"):
            continue
        with open(fa + ".fai", encoding="utf-8") as fh:
            for line in fh:
                n = int(line.split("\t")[1])
                total += n if n < limit else 0
    return total


def _sketch_backend(name: str, short_bases: int = 0):
    """Pick the sketch implementation.

    auto: the GPU kernels (``pallas``) when JAX's default backend is a GPU
    and the job has at least ``_AUTO_MIN_SHORT_BASES`` bases in short
    records (``_short_record_bases``); else the native C++ sketcher, else
    the NumPy oracle.  JAX is imported only once the job says the device
    could be used, so host-only runs stay light.  All backends are
    bit-identical; the parity suites enforce it.
    """
    auto = name == "auto"
    if auto:
        name = "native"
        if short_bases >= _AUTO_MIN_SHORT_BASES:
            import jax

            if jax.default_backend() == "gpu":
                name = "pallas"
    if name == "pallas":
        import jax

        if jax.default_backend() != "gpu":
            raise SystemExit(
                "ERROR: backend=pallas needs a GPU; JAX runs on "
                f"{jax.default_backend()}"
            )
        from ntjoin_tpu.ops.sketch_gpu import sketch_codes_gpu
        from ntjoin_tpu.utils.jaxcfg import enable_compile_cache

        enable_compile_cache()
        return sketch_codes_gpu
    if name == "jax":
        from ntjoin_tpu.ops.sketch_jax import sketch_codes_jax
        from ntjoin_tpu.utils.jaxcfg import enable_compile_cache

        enable_compile_cache()
        return sketch_codes_jax
    if name == "native":
        from ntjoin_tpu.io.native import available, sketch_codes_native

        if available():
            return sketch_codes_native
        if not auto:
            raise RuntimeError("native library unavailable (make -C native)")
    elif name != "numpy":
        raise SystemExit(f"ERROR: unknown backend {name!r}")
    from ntjoin_tpu.ops.nthash_np import sketch_codes

    return sketch_codes


def _is_device_sketch(backend) -> bool:
    return _SKETCH_NAMES.get(backend.__name__) in ("pallas", "jax")


def _ensure_sketch(
    fasta: str, k: int, w: int, force: bool, backend, timers: StageTimers,
) -> tuple[str, AssemblySketch | None]:
    """Compute (or reuse) the minimizer TSV for one assembly.

    Make-style incrementality: reuse the TSV when it is newer than its FASTA
    (reference relies on Make timestamps, ``ntJoin:204-205``).
    """
    tsv = f"{fasta}.k{k}.w{w}.tsv"
    fresh = (
        not force
        and os.path.exists(tsv)
        and os.path.getmtime(tsv) >= os.path.getmtime(fasta)
    )
    if fresh:
        return tsv, None
    with timers.stage(f"sketch:{os.path.basename(fasta)}"):
        records = read_fasta(fasta)
        if backend.__name__ == "sketch_codes_gpu":
            from ntjoin_tpu.ops.sketch_gpu import sketch_records_gpu

            # batched: many records per device program
            sketches = sketch_records_gpu([r.codes for r in records], k, w)
            for r in records:
                r._codes = None
        else:
            sketches = []
            for rec in records:
                sketches.append(backend(rec.codes, k, w))
                rec._codes = None  # drop per-record code cache
        write_minimizer_tsv(tsv, records, sketches, k)
    import numpy as np

    hs, ps, cs = [], [], []
    names = []
    for i, (rec, sk) in enumerate(zip(records, sketches)):
        names.append(rec.id)
        hs.append(np.asarray(sk.hashes, dtype=np.uint64))
        ps.append(np.asarray(sk.positions, dtype=np.int64))
        cs.append(np.full(len(sk.positions), i, dtype=np.int32))
    sketch = AssemblySketch.from_stream(
        tsv,
        1.0,
        names,
        np.concatenate(hs) if hs else np.empty(0, np.uint64),
        np.concatenate(ps) if ps else np.empty(0, np.int64),
        np.concatenate(cs) if cs else np.empty(0, np.int32),
    )
    return tsv, sketch


def assemble(words: list[str]) -> int:
    force = "-B" in words
    words = [w for w in words if not w.startswith("-")]
    v = _parse_vars(words)

    if v["reference_config"] != "None":
        refs, weights = [], []
        with open(v["reference_config"], encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(",")
                refs.append(parts[0])
                weights.append(parts[1])
        v["references"] = " ".join(refs)
        v["reference_weights"] = " ".join(weights)

    for req in ("target", "references", "reference_weights"):
        if v[req] == "None":
            print(f"ERROR: Must set {req}", file=sys.stderr)
            return 1

    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    prefix = v["prefix"] or f"out.k{k}.w{w}.n{n}"
    overlap_g = v["overlap_g"] or v["g"]

    if int(v["n_procs"]) > 1 or v["coordinator"] != "None":
        # distributed mode: record-shard -> sketch -> collective filter ->
        # survivor exchange -> process-0 scaffold (parallel/pipeline.py)
        from ntjoin_tpu.parallel.pipeline import (
            DistributedConfig,
            distributed_assemble,
        )

        dcfg = DistributedConfig(
            target=v["target"],
            references=v["references"].split(),
            reference_weights=[float(x) for x in v["reference_weights"].split()],
            target_weight=float(v["target_weight"]),
            prefix=prefix,
            k=k,
            w=w,
            n=n,
            coordinator=None if v["coordinator"] == "None" else v["coordinator"],
            num_processes=int(v["n_procs"]),
            process_id=int(v["process_id"]),
            local_device_count=(
                None if v["local_devices"] == "None" else int(v["local_devices"])
            ),
            scaffold_opts=dict(
                g=int(v["g"]),
                G=int(v["G"]),
                mkt=_truthy(v["mkt"]),
                m=int(v["m"]),
                t=int(v["assemble_t"]),
                agp=_truthy(v["agp"]),
                no_cut=_truthy(v["no_cut"]),
                overlap=_truthy(v["overlap"]),
                overlap_gap=int(overlap_g),
                overlap_k=int(v["overlap_k"]),
                overlap_w=int(v["overlap_w"]),
            ),
        )
        distributed_assemble(dcfg)
        return 0

    timers = StageTimers(enabled=_truthy(v["time"]), prefix=prefix)
    references = v["references"].split()
    fastas = references + [v["target"]]
    for fa in fastas:
        # the .fai artifact has its own Make-style freshness (a regenerated
        # FASTA must not keep an index with the old byte offsets, and a
        # deleted .fai must come back even when the TSV is fresh)
        fai = fa + ".fai"
        if force or not os.path.exists(fai) or (
            os.path.getmtime(fai) < os.path.getmtime(fa)
        ):
            write_fai(fa)
    short = _short_record_bases(fastas, k, w) if v["backend"] == "auto" else 0
    backend = _sketch_backend(v["backend"], short_bases=short)
    index_backend = v["index_backend"]
    if index_backend == "auto":
        index_backend = "device" if _is_device_sketch(backend) else "host"
    device = "host"
    if _is_device_sketch(backend) or index_backend == "device":
        import jax

        # one process drives the default device; several cards are used
        # by one process each (coordinator= mode)
        dev = jax.devices()[0]
        device = f"{dev.platform} ({dev.device_kind})"
    print(
        f"ntjoin: sketch={_SKETCH_NAMES[backend.__name__]} "
        f"index={index_backend} device={device}",
        file=sys.stderr, flush=True,
    )

    cache: dict[str, AssemblySketch] = {}
    ref_tsvs = []
    for fa in references:
        tsv, sk = _ensure_sketch(fa, k, w, force, backend, timers)
        ref_tsvs.append(tsv)
        if sk is not None:
            cache[tsv] = sk
    target_tsv, sk = _ensure_sketch(v["target"], k, w, force, backend, timers)
    if sk is not None:
        cache[target_tsv] = sk

    cfg = ScaffoldConfig(
        references=ref_tsvs,
        target=target_tsv,
        target_weight=float(v["target_weight"]),
        reference_weights=[float(x) for x in v["reference_weights"].split()],
        prefix=prefix,
        n=n,
        k=k,
        w=w,
        g=int(v["g"]),
        G=int(v["G"]),
        mkt=_truthy(v["mkt"]),
        m=int(v["m"]),
        t=int(v["assemble_t"]),
        agp=_truthy(v["agp"]),
        no_cut=_truthy(v["no_cut"]),
        overlap=_truthy(v["overlap"]),
        overlap_gap=int(overlap_g),
        overlap_k=int(v["overlap_k"]),
        overlap_w=int(v["overlap_w"]),
        index_backend=index_backend,
    )
    with timers.stage("scaffold"):
        Scaffolder(cfg, sketch_cache=cache).run()

    base = f"{v['target']}.k{k}.w{w}.n{n}"
    from ntjoin_tpu.utils.atomic import atomic_write

    import shutil

    with atomic_write(f"{base}.all.scaffolds.fa", mode="wb") as out:
        for part in (f"{base}.assigned.scaffolds.fa", f"{base}.unassigned.scaffolds.fa"):
            if os.path.exists(part):
                # streamed binary copy: fh.read() here was a whole-genome
                # transient string (~3 GB at the north-star config)
                with open(part, "rb") as fh:
                    shutil.copyfileobj(fh, out, length=16 << 20)
    if _truthy(v["gzip"]):
        # mirror of the reference's ``%.fa.gz: %.fa`` rule (ntJoin:109-114,
        # 210-211): pigz -p$t -f when available, else gzip -f — either way
        # the uncompressed file is replaced by ``<file>.gz``
        for part in (
            f"{base}.assigned.scaffolds.fa",
            f"{base}.unassigned.scaffolds.fa",
            f"{base}.all.scaffolds.fa",
        ):
            if os.path.exists(part):
                _gzip_artifact(part, threads=int(v["t"]))
    timers.report()
    return 0


def _gzip_artifact(path: str, threads: int = 4) -> str:
    """Compress ``path`` in place to ``path.gz`` (pigz > gzip > stdlib)."""
    import shutil
    import subprocess

    if shutil.which("pigz"):
        subprocess.run(["pigz", f"-p{threads}", "-f", path], check=True)
    elif shutil.which("gzip"):
        subprocess.run(["gzip", "-f", path], check=True)
    else:  # stdlib fallback so the rule works in tool-less images
        import gzip as _gz

        with open(path, "rb") as src, _gz.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(path)
    return path + ".gz"


def _resolve_fasta(path: str) -> str | None:
    """Existing path for a FASTA artifact, accepting the gzip=True variant
    (``assemble gzip=True`` replaces ``<fa>`` with ``<fa>.gz``; minimap2,
    QUAST and our reader all take gzipped FASTA directly)."""
    if os.path.exists(path):
        return path
    if os.path.exists(path + ".gz"):
        return path + ".gz"
    return None


def analysis(words: list[str]) -> int:
    """Alignment/QUAST evaluation of inputs and outputs vs a truth reference
    (mirror of the reference's ``analysis`` Make target, ``ntJoin:158-161``)."""
    from ntjoin_tpu.analysis import MissingToolError, align_to_reference

    v = _parse_vars([w for w in words if not w.startswith("-")])
    ref = v.get("ref", "None")
    if ref == "None":
        print("ERROR: must set ref", file=sys.stderr)
        return 1
    if v["target"] == "None":
        print("ERROR: Must set target", file=sys.stderr)
        return 1
    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    references = v["references"].split() if v["references"] != "None" else []
    targets = references + [
        v["target"],
        f"{v['target']}.k{k}.w{w}.n{n}.all.scaffolds.fa",
    ]
    try:
        for fa in targets:
            fa = _resolve_fasta(fa)
            if fa is not None:
                bam = align_to_reference(fa, ref, threads=int(v["t"]))
                print(f"aligned {fa} -> {bam}")
    except MissingToolError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    return 0


def quast(words: list[str]) -> int:
    """QUAST evaluation of references + target + all.scaffolds vs a truth
    reference (mirror of the reference's ``quast_$(prefix)/report.tsv``
    target, ``ntJoin:244-252``): ``--fast --scaffold-gap-max-size 100000
    --split-scaffolds`` plus ``--large`` when ``large=1``."""
    from ntjoin_tpu.analysis import MissingToolError, run_quast

    v = _parse_vars([w for w in words if not w.startswith("-")])
    ref = v.get("ref", "None")
    if ref == "None":
        print("ERROR: must set ref", file=sys.stderr)
        return 1
    if v["target"] == "None":
        print("ERROR: Must set target", file=sys.stderr)
        return 1
    k, w, n = int(v["k"]), int(v["w"]), int(v["n"])
    prefix = v["prefix"] or f"out.k{k}.w{w}.n{n}"
    references = v["references"].split() if v["references"] != "None" else []
    assemblies = [
        fa
        for fa in (
            _resolve_fasta(p)
            for p in references
            + [v["target"], f"{v['target']}.k{k}.w{w}.n{n}.all.scaffolds.fa"]
        )
        if fa is not None
    ]
    try:
        report = run_quast(
            assemblies, ref, f"quast_{prefix}", threads=int(v["t"]),
            large=v.get("large", "0") == "1",
        )
    except MissingToolError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    print(f"QUAST report: {report}")
    return 0


HELP_TEXT = """
ntjoin-tpu: Scaffolding assemblies using reference assemblies and minimizer graphs
{version}
Usage: ntjoin-tpu assemble target=<target scaffolds> references='List of reference assemblies' reference_weights='List of weights per reference assembly'

Options:
target\t\t\tTarget assembly to be scaffolded in fasta format
references\t\tList of reference files (separated by a space, in fasta format)
target_weight\t\tWeight of target assembly [1]
reference_weights\tList of weights of reference assemblies
prefix\t\t\tPrefix of intermediate output files [out.k<k>.w<w>.n<n>]
t\t\t\tNumber of threads [4]
assemble_t\t\tNumber of threads for assembling stage [1]
k\t\t\tK-mer size for minimizers [32]
w\t\t\tWindow size for minimizers (bp) [1000]
n\t\t\tMinimum graph edge weight [1]
g\t\t\tMinimum gap size (bp) [20]
G\t\t\tMaximum gap size (bp) (0 if no maximum) [0]
m\t\t\tMinimum percentage of increasing/decreasing minimizer positions to orient contig [90]
mkt\t\t\tIf True, use Mann-Kendall Test to predict contig orientation (computationally-intensive, overrides 'm') [False]
agp\t\t\tIf True, output AGP file describing output scaffolds [False]
no_cut\t\t    \tIf True, will not cut contigs at putative misassemblies [False]
overlap\t\t\tIf True, attempts to detect and trim overlaps between joined sequences [True]
overlap_g\t\tGap size between trimmed overlapping segments (used if overlap=True) [g]
overlap_k\t\tK-mer size for overlap minimizers (bp) [15]
overlap_w\t\tWindow size for overlap minimizers (bp) [10]
time\t\t    \tIf True, will log the time for each step [False]
gzip\t\t\tIf True, gzip the output scaffold FASTAs (pigz -p t when available) [False]
reference_config\tConfig file with reference assemblies and reference weights as comma-separated values (See README for example)
\t\t\t This is optional, and will override the 'references' and 'reference_weights' variables if specified

Accelerator options:
backend\t\t\tMinimizer sketch backend: auto | pallas (GPU kernels) | jax | native | numpy [auto]
index_backend\t\tFilter/graph stage placement: auto | device | host [auto]
n_procs\t\t\tMulti-process distributed mode: total process count [1]
process_id\t\tThis process's id (0..n_procs-1) [0]
coordinator\t\tjax.distributed coordinator address; each process sketches its records on the host and pins the card of its local rank (localhost:<port>: process_id; else LOCAL_RANK) [None]
local_devices\t\tDevices visible to this process (distributed mode) [None]

Notes:
\t- Ensure the lists of reference assemblies and weights are in the same order, and that both are space-separated
\t- Ensure all assembly files are in the current working directory

Other commands:
\tntjoin-tpu analysis target=... references=... ref=truth.fa   minimap2+samtools alignment of inputs/outputs
\tntjoin-tpu quast target=... references=... ref=truth.fa      QUAST evaluation report
\tntjoin-tpu all target=... references=...                     assemble then analysis
\tntjoin-tpu version | check_install
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        # per-parameter manual, surface-for-surface with the reference's
        # `ntJoin help` (ntJoin:117-147)
        print(HELP_TEXT.format(version=VERSION))
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(VERSION)
        return 0
    if cmd == "check_install":
        # counterpart of the reference's check_install target (ntJoin:192-198)
        import numpy  # noqa: F401

        from ntjoin_tpu.io.native import available
        from ntjoin_tpu.ops.nthash_np import sketch_seq

        sk = sketch_seq("ACGT" * 64, 15, 10)
        assert sk.positions.size > 0
        print("core sketch: OK")
        print(f"native library: {'OK' if available() else 'MISSING (make -C native)'}")
        import jax

        dev = jax.devices()[0]
        print(f"accelerator: {dev.platform} ({dev.device_kind})")
        return 0
    if cmd == "assemble":
        return assemble(rest)
    if cmd == "analysis":
        return analysis(rest)
    if cmd == "quast":
        return quast(rest)
    if cmd == "all":
        rc = assemble(rest)
        return rc or analysis(rest)
    print(
        f"ERROR: unknown command {cmd!r} (try: assemble, analysis, all, version, help)",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
