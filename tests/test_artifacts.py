"""Artifact-level byte equality: reference goldens + self-regression pins."""
import os
import shutil
import subprocess
import sys
import pytest

REF = "/root/reference/tests"
GOLDEN = f"{REF}/expected_outputs"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELF_GOLDEN = os.path.join(REPO, "tests", "golden")


def _run(workdir, *args):
    cmd = [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
           "backend=numpy", *args]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr + res.stdout
    return res


def test_ff_artifacts_match_reference_goldens(tmp_path):
    """Full artifact set of the f-f case vs the reference's expected_outputs.

    The reference's install check compares these files byte-for-byte
    (tests/test_installation.sh); we assert the same set from pytest.  The
    golden TSV is the historical 2-field format and the DOT predates the
    label prefix, so those two are compared structurally elsewhere.
    """
    for f in ["ref.fa", "scaf.f-f.fa"]:
        shutil.copy(f"{REF}/{f}", tmp_path / f)
    _run(tmp_path, "target=scaf.f-f.fa", "target_weight=1", "references=ref.fa",
         "reference_weights=2", "prefix=f-f_test", "k=32", "w=1000", "n=2",
         "overlap=False")
    for name in [
        "scaf.f-f.fa.k32.w1000.n2.assigned.scaffolds.fa",
        "scaf.f-f.fa.k32.w1000.n2.unassigned.scaffolds.fa",
        "scaf.f-f.fa.k32.w1000.n2.all.scaffolds.fa",
    ]:
        golden = name.replace(".n2.", ".n1.")  # golden set was built with n=1
        assert (tmp_path / name).read_bytes() == open(f"{GOLDEN}/{golden}", "rb").read(), name
    assert (tmp_path / "scaf.f-f.fa.fai").read_bytes() == open(f"{GOLDEN}/scaf.f-f.fa.fai", "rb").read()
    assert (tmp_path / "ref.fa.fai").read_bytes() == open(f"{GOLDEN}/ref.fa.fai", "rb").read()
    assert (
        (tmp_path / "f-f_test.scaf.f-f.fa.k32.w1000.tsv.unassigned.bed").read_bytes()
        == open(f"{GOLDEN}/f-f_test.scaf.f-f.fa.k32.w1000.tsv.unassigned.bed", "rb").read()
    )
    got_path = [ln for ln in (tmp_path / "f-f_test.path").read_text().splitlines()]
    want_path = open(f"{GOLDEN}/f-f_test.path").read().splitlines()
    assert got_path == want_path


def test_overlap_agp_self_golden(tmp_path):
    """Self-regression pin: the overlap+AGP artifact set for f-r.overlapping.

    The reference has no goldens for this configuration; this snapshot locks
    the full writer stack (path/agp/fasta/bed/dot edge section) against
    regressions.  Regenerate with REGEN=1 after intentional changes.
    """
    for f in ["ref.fa", "scaf.f-r.overlapping.fa"]:
        shutil.copy(f"{REF}/{f}", tmp_path / f)
    _run(tmp_path, "target=scaf.f-r.overlapping.fa", "target_weight=1",
         "references=ref.fa", "reference_weights=2", "prefix=ovl", "k=32",
         "w=1000", "n=2", "overlap=True", "agp=True")
    names = [
        "ovl.path",
        "ovl.agp",
        "ovl.mx.dot",
        "ovl.scaf.f-r.overlapping.fa.k32.w1000.tsv.unassigned.bed",
        "scaf.f-r.overlapping.fa.k32.w1000.n2.all.scaffolds.fa",
        "scaf.f-r.overlapping.fa.k32.w1000.tsv",
    ]
    os.makedirs(SELF_GOLDEN, exist_ok=True)
    for name in names:
        golden_path = os.path.join(SELF_GOLDEN, name)
        if os.environ.get("REGEN") == "1" or not os.path.exists(golden_path):
            shutil.copy(tmp_path / name, golden_path)
        assert (tmp_path / name).read_bytes() == open(golden_path, "rb").read(), name


def test_fasta_store_subseq(tmp_path):
    """mmap-backed FastaStore slices match in-memory records, across line
    widths, boundaries, and the gz fallback."""
    from ntjoin_tpu.io.fasta import FastaStore, read_fasta_dict

    import gzip
    import numpy as np

    rng = np.random.default_rng(11)
    seqs = {
        "a": "".join("ACGT"[i] for i in rng.integers(0, 4, 257)),
        "b": "".join("ACGTN"[i] for i in rng.integers(0, 5, 80)),
        "c": "A",
    }
    fa = tmp_path / "s.fa"
    with open(fa, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name} extra comment\n")
            for i in range(0, len(seq), 60):
                fh.write(seq[i : i + 60] + "\n")
    store = FastaStore(str(fa))
    assert store.names() == ["a", "b", "c"]
    for name, seq in seqs.items():
        assert store.length(name) == len(seq)
        assert store.subseq(name, 0, len(seq)) == seq
        assert store.subseq(name, 0, 0) == ""
        for s, e in [(0, 1), (59, 61), (60, 120), (3, len(seq)),
                     (len(seq) - 1, len(seq)), (0, 10**9)]:
            e_c = min(e, len(seq))
            s_c = min(s, len(seq))
            assert store.subseq(name, s, e) == seq[s_c:e_c], (name, s, e)
    store.close()

    gz = tmp_path / "s.fa.gz"
    with open(fa, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    gstore = FastaStore(str(gz))
    assert gstore.names() == ["a", "b", "c"]
    for name, seq in seqs.items():
        assert gstore.subseq(name, 2, 40) == seq[2:40]
    # sanity: both agree with the eager reader
    recs = read_fasta_dict(str(fa))
    assert {n: r.seq for n, r in recs.items()} == seqs


def test_fasta_store_ragged_lines(tmp_path):
    """Non-uniform sequence line widths must not corrupt subseq slices.

    samtools faidx refuses to index such files; the reference's btllib
    SeqReader reads them fine, so the framework must too: the fai writer
    marks ragged records with a linebases=linewidth=0 sentinel and
    FastaStore materialises them from the raw bytes instead of doing
    byte-offset arithmetic (round-4 advisor finding)."""
    from ntjoin_tpu.io.fasta import FastaStore, write_fai

    import numpy as np

    rng = np.random.default_rng(7)
    seqs = {
        "uniform": "".join("ACGT"[i] for i in rng.integers(0, 4, 200)),
        "ragged": "".join("ACGT"[i] for i in rng.integers(0, 4, 311)),
        "blanky": "".join("ACGT"[i] for i in rng.integers(0, 4, 90)),
        "tail": "".join("ACGT"[i] for i in rng.integers(0, 4, 73)),
    }
    fa = tmp_path / "ragged.fa"
    with open(fa, "w") as fh:
        fh.write(">uniform\n")
        for i in range(0, 200, 60):
            fh.write(seqs["uniform"][i : i + 60] + "\n")
        fh.write(">ragged desc\n")
        # widths 50, 70, 50, ... — first-line-based arithmetic lands mid-line
        cuts = [0, 50, 120, 170, 240, 311]
        for a, b in zip(cuts, cuts[1:]):
            fh.write(seqs["ragged"][a:b] + "\n")
        fh.write(">blanky\n")
        fh.write(seqs["blanky"][:45] + "\n\n")  # interior blank line
        fh.write(seqs["blanky"][45:] + "\n")
        fh.write(">tail\n")
        fh.write(seqs["tail"] + "\n")

    # both fai writers (native + python) must agree on the sentinel
    from ntjoin_tpu.io import native as _native

    write_fai(str(fa), str(tmp_path / "native.fai"))
    rows_n = (tmp_path / "native.fai").read_text().splitlines()
    if _native.available():
        # force the pure-python scan for comparison
        import ntjoin_tpu.io.fasta as fasta_mod

        orig = _native._load
        try:
            _native._load = lambda: None
            fasta_mod.write_fai(str(fa), str(tmp_path / "py.fai"))
        finally:
            _native._load = orig
        assert (tmp_path / "py.fai").read_text().splitlines() == rows_n
    got = {r.split("\t")[0]: r.split("\t") for r in rows_n}
    assert got["uniform"][3:5] == ["60", "61"]
    assert got["ragged"][3:5] == ["0", "0"]
    assert got["blanky"][3:5] == ["0", "0"]
    assert got["tail"][1] == "73"

    store = FastaStore(str(fa))
    for name, seq in seqs.items():
        assert store.length(name) == len(seq), name
        assert store.subseq(name, 0, len(seq)) == seq, name
        for s, e in [(0, 1), (49, 51), (45, 130), (3, len(seq)),
                     (len(seq) - 1, len(seq))]:
            assert store.subseq(name, s, e) == seq[s:e], (name, s, e)
    store.close()

    # Stale .fai written by offset arithmetic that doesn't match the file
    # (e.g. an index from before the file was edited ragged but same mtime):
    # the load-time spot check must catch it.
    bad = tmp_path / "bad.fa"
    with open(bad, "w") as fh:
        fh.write(">r\n")
        fh.write(seqs["ragged"][:50] + "\n" + seqs["ragged"][50:120] + "\n")
        fh.write(seqs["ragged"][120:170] + "\n")
    with open(str(bad) + ".fai", "w") as fh:
        fh.write("r\t170\t3\t50\t51\n")  # claims uniform 50-wide lines
    import os as _os
    import time as _time

    now = _time.time() + 5
    _os.utime(str(bad) + ".fai", (now, now))
    store2 = FastaStore(str(bad))
    assert store2.subseq("r", 0, 170) == seqs["ragged"][:170]
    assert store2.subseq("r", 60, 100) == seqs["ragged"][60:100]
    store2.close()


def test_atomic_artifact_writes(tmp_path, monkeypatch):
    """Crash-safe artifacts (reference .DELETE_ON_ERROR parity,
    ntJoin:201): a run dying mid-TSV-write must leave NO fresh-mtimed
    partial sketch for the next run's timestamp reuse to trust, and the
    next run must re-sketch and succeed."""
    import ntjoin_tpu.cli as cli
    from ntjoin_tpu.utils.atomic import atomic_write

    for f in ["ref.fa", "scaf.f-f.fa"]:
        shutil.copy(f"{REF}/{f}", tmp_path / f)
    monkeypatch.chdir(tmp_path)

    real_writer = cli.write_minimizer_tsv
    wrote = {"n": 0}

    def dying_writer(out_path, records, sketches, k, with_seq=True):
        wrote["n"] += 1
        with atomic_write(out_path) as out:
            out.write("scaf\t123:45:ACGT")  # partial, no trailing newline
            raise RuntimeError("simulated crash mid-write")

    args = ["backend=numpy", "target=scaf.f-f.fa", "target_weight=1",
            "references=ref.fa", "reference_weights=2", "prefix=atomic",
            "k=32", "w=1000", "n=2", "overlap=False"]
    monkeypatch.setattr(cli, "write_minimizer_tsv", dying_writer)
    with pytest.raises(RuntimeError, match="simulated crash"):
        cli.assemble(list(args))
    assert wrote["n"] == 1
    # neither the artifact nor any temp litter survives the crash
    assert not list(tmp_path.glob("*.tsv"))
    assert not list(tmp_path.glob("*.tmp.*"))

    # next run re-sketches (stale-artifact reuse finds nothing) and works
    monkeypatch.setattr(cli, "write_minimizer_tsv", real_writer)
    assert cli.assemble(list(args)) == 0
    assert (tmp_path / "ref.fa.k32.w1000.tsv").exists()
    lines = [ln for ln in (tmp_path / "atomic.path").read_text().splitlines()
             if ln.startswith("ntJoin")]
    assert lines == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def test_help_lists_every_parameter(capsys):
    """`ntjoin-tpu help` prints the reference's per-parameter manual
    (ntJoin:117-147 surface) covering every accepted key=value option."""
    from ntjoin_tpu.cli import _DEFAULTS, main

    assert main(["help"]) == 0
    out = capsys.readouterr().out
    for key in _DEFAULTS:
        assert f"\n{key}\t" in out, f"help text missing option {key!r}"
    for phrase in (
        "Scaffolding assemblies using reference assemblies",
        "Mann-Kendall",
        "reference_config",
        "same order",
    ):
        assert phrase in out


def test_auto_routing_gz_size_estimate(tmp_path, monkeypatch):
    """backend=auto routes on the bases of short records, read from the
    .fai indexes: a plain FASTA's records count by their lengths, a
    gzipped one (no index to read; no decompression just to route)
    counts none."""
    import gzip

    import numpy as np

    import ntjoin_tpu.cli as cli

    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 20_000))
    gz = tmp_path / "big.fa.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write(">x\n" + seq + "\n")
    (tmp_path / "plain.fa").write_text(">y\n" + seq + "\n>z\n" + seq[:9_000] + "\n")

    seen = {}

    def spy_backend(name, short_bases=0):
        seen["bases"] = short_bases
        raise SystemExit(0)  # stop before any real work

    monkeypatch.setattr(cli, "_sketch_backend", spy_backend)
    monkeypatch.setattr(cli.os, "cpu_count", lambda: 16)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        cli.assemble([
            "backend=auto", f"target={gz.name}", "target_weight=1",
            "references=plain.fa", "reference_weights=2",
        ])
    assert seen["bases"] == 29_000


def test_fasta_store_ragged_last_line_longer(tmp_path):
    """A FINAL record whose last sequence line is LONGER than linebases
    must be detected by both fai writers (flush-time check) and by the
    stale-fai byte-span spot check (round-5 review finding)."""
    from ntjoin_tpu.io.fasta import FastaStore, write_fai

    fa = tmp_path / "last.fa"
    seq = "ACGTAC" + "GTCAGTCAGT"  # lines 6 then 10 (longer than first)
    fa.write_text(">r\nACGTAC\nGTCAGTCAGT\n")

    # our writers mark it ragged
    write_fai(str(fa))
    row = (tmp_path / "last.fa.fai").read_text().split("\t")
    assert row[3:5] == ["0", "0\n"], row
    store = FastaStore(str(fa))
    assert store.subseq("r", 12, 16) == seq[12:16] == "CAGT"
    assert store.subseq("r", 0, 16) == seq
    store.close()

    # a stale uniform-claiming .fai is caught by the byte-span check
    import os as _os
    import time as _time

    with open(str(fa) + ".fai", "w") as fh:
        fh.write("r\t16\t3\t6\t7\n")
    now = _time.time() + 5
    _os.utime(str(fa) + ".fai", (now, now))
    store2 = FastaStore(str(fa))
    assert store2.subseq("r", 12, 16) == "CAGT"
    store2.close()


def test_fai_empty_record_rows(tmp_path):
    """Empty records write linebases/linewidth 0/0 like samtools, not the
    previous record's stale values — native and python writers agree."""
    from ntjoin_tpu.io import native as nat
    from ntjoin_tpu.io.fasta import write_fai

    fa = tmp_path / "e.fa"
    fa.write_text(">a\nACGTAC\nACGTAC\nACG\n>empty\n>b\nAC\n")
    write_fai(str(fa), str(tmp_path / "n.fai"))
    orig = nat._load
    try:
        nat._load = lambda: None
        write_fai(str(fa), str(tmp_path / "p.fai"))
    finally:
        nat._load = orig
    n = (tmp_path / "n.fai").read_text()
    assert n == (tmp_path / "p.fai").read_text()
    rows = {r.split("\t")[0]: r.split("\t") for r in n.splitlines()}
    assert rows["empty"][1] == "0" and rows["empty"][3:] == ["0", "0"]
    assert rows["a"][3:] == ["6", "7"] and rows["b"][1] == "2"
