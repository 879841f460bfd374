"""End-to-end pipeline tests — ports of the reference's full pytest suite.

Every expected path/AGP string below is copied verbatim from the reference
assertions (``tests/ntjoin_test.py:81-225``); these strings are the
byte-equivalence contract of the framework.  Runs happen in a temp dir via
the CLI, exactly as the reference suite shells through its Makefile.
"""
import os
import shutil
import subprocess
import sys

import pytest

REF = "/root/reference/tests"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIXTURES = [
    "ref.fa",
    "ref.multiple.fa",
    "scaf.f-f.fa",
    "scaf.f-f.copy.fa",
    "scaf.f-f.overlapping.fa",
    "scaf.f-f.termN.fa",
    "scaf.f-f.termN.unassigned.fa",
    "scaf.f-r.fa",
    "scaf.f-r.overlapping.fa",
    "scaf.misassembled.f-f.r-r.fa",
    "scaf.misassembled.f-r.r-f.fa",
    "scaf.multiple.fa",
    "scaf.r-f.fa",
    "scaf.r-r.fa",
    "scaf.r-r.overlapping.fa",
    "test_config_multiple.csv",
    "test_config_single.csv",
]


@pytest.fixture
def workdir(tmp_path):
    for f in FIXTURES:
        shutil.copy(os.path.join(REF, f), tmp_path / f)
    return tmp_path


def launch(workdir, prefix, *args):
    # backend=numpy: the oracle sketch; jax/pallas bit-parity is covered by
    # the dedicated parity suites, no need to pay device compiles per test.
    cmd = [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
           "backend=numpy", *args]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr + res.stdout
    paths = []
    with open(workdir / f"{prefix}.path") as fh:
        for line in fh:
            if line.startswith("ntJoin"):
                paths.append(line.strip())
    return paths


def run_pair(workdir, ref, target, prefix, window=1000, n=2, **kw):
    extra = [f"{k}={v}" for k, v in kw.items()]
    return launch(
        workdir, prefix,
        f"target={target}", "target_weight=1", f"references={ref}",
        "reference_weights=2", f"prefix={prefix}", "k=32", f"w={window}",
        f"n={n}", *extra,
    )


def run_agp(workdir, ref, target, prefix, window=1000, n=2, **kw):
    run_pair(workdir, ref, target, prefix, window, n, agp="True", **kw)
    with open(workdir / f"{prefix}.agp") as fh:
        return [line.strip() for line in fh]


# -- orientation cases (reference ntjoin_test.py:81-111) --


def test_mx_f_f(workdir):
    paths = run_pair(workdir, "ref.fa", "scaf.f-f.fa", "f-f_test", overlap="False")
    assert paths == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def test_mx_f_f_termN(workdir):
    paths = run_pair(workdir, "ref.fa", "scaf.f-f.termN.fa", "f-f_test", overlap="False")
    assert paths == ["ntJoin0\t1_f+:4-1985 20N 2_f+:0-2329"]


def test_mx_f_r(workdir):
    paths = run_pair(workdir, "ref.fa", "scaf.f-r.fa", "f-r_test", overlap="False")
    assert paths == ["ntJoin0\t1_f+:0-1981 20N 2_r-:0-2329"]


def test_mx_r_f(workdir):
    paths = run_pair(workdir, "ref.fa", "scaf.r-f.fa", "r-f_test", overlap="False")
    assert paths == ["ntJoin0\t1_r-:0-1981 20N 2_f+:0-2329"]


def test_mx_r_r(workdir):
    paths = run_pair(workdir, "ref.fa", "scaf.r-r.fa", "r-r_test", overlap="False")
    assert paths == ["ntJoin0\t1_r-:0-1981 20N 2_r-:0-2329"]


# -- gap estimation (reference :115-122) --


def test_gap_dist_multiple(workdir):
    paths = run_pair(
        workdir, "ref.multiple.fa", "scaf.multiple.fa", "gap-dist_test",
        window=500, n=1, overlap="False",
    )
    assert len(paths) == 2
    got = {p.split("\t")[1] for p in paths}
    assert got == {"2_1_p+:0-2492 100N 2_2_n-:0-2574", "1_1_p+:0-1744 124N 1_2_p+:0-1844"}


# -- misassembly cutting (reference :128-158) --


def test_regions_ff_rr(workdir):
    paths = run_pair(
        workdir, "ref.multiple.fa", "scaf.misassembled.f-f.r-r.fa",
        "regions-ff-rr_test", window=500, n=1, overlap="False",
    )
    assert len(paths) == 2
    got = {p.split("\t")[1] for p in paths}
    assert got == {
        "2_1n-1_2p-:0-2232 20N 1_1p-2_2n-:2110-4489",
        "1_1p-2_2n+:0-1568 477N 2_1n-1_2p+:2712-4379",
    }


def test_regions_ff_rr_nocut(workdir):
    paths = run_pair(
        workdir, "ref.multiple.fa", "scaf.misassembled.f-f.r-r.fa",
        "regions-ff-rr-nocut_test", window=500, n=1, no_cut="True", overlap="False",
    )
    assert len(paths) == 1
    assert paths[0].split("\t")[1] == "2_1n-1_2p-:0-4379 20N 1_1p-2_2n-:0-4489"


def test_regions_fr_rf(workdir):
    paths = run_pair(
        workdir, "ref.multiple.fa", "scaf.misassembled.f-r.r-f.fa",
        "regions-fr-rf_test", window=500, n=2,
    )
    assert len(paths) == 2
    got = {p.split("\t")[1] for p in paths}
    assert got == {
        "2_1n-1_2n-:0-2232 253N 1_1p-2_2p+:2058-4489",
        "1_1p-2_2p+:0-1624 191N 2_1n-1_2n-:2518-4379",
    }


def test_regions_fr_rf_config(workdir):
    paths = launch(
        workdir, "regions-fr-rf_test",
        "target=scaf.misassembled.f-r.r-f.fa", "target_weight=1",
        "reference_config=test_config_single.csv", "prefix=regions-fr-rf_test",
        "k=32", "w=500", "n=2",
    )
    assert len(paths) == 2
    got = {p.split("\t")[1] for p in paths}
    assert got == {
        "2_1n-1_2n-:0-2232 253N 1_1p-2_2p+:2058-4489",
        "1_1p-2_2p+:0-1624 191N 2_1n-1_2n-:2518-4379",
    }


# -- multiple references (reference :161-177) --


def test_regions_3(workdir):
    paths = launch(
        workdir, "f-f-f_test",
        "target=scaf.f-f.fa", "target_weight=1",
        "references=ref.fa scaf.f-f.copy.fa", "reference_weights=2 2",
        "prefix=f-f-f_test", "k=32", "w=1000", "n=1",
    )
    assert paths == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def test_regions_3_config(workdir):
    paths = launch(
        workdir, "f-f-f_test",
        "target=scaf.f-f.fa", "target_weight=1",
        "reference_config=test_config_multiple.csv",
        "prefix=f-f-f_test", "k=32", "w=1000", "n=1",
    )
    assert paths == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def test_regions_3_config_extra(workdir):
    paths = launch(
        workdir, "f-f-f_test",
        "target=scaf.f-f.fa", "target_weight=1", "reference=na",
        "reference_weights=na", "reference_config=test_config_multiple.csv",
        "prefix=f-f-f_test", "k=32", "w=1000", "n=1",
    )
    assert paths == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


# -- AGP output (reference :180-196) --


def test_mx_r_f_agp(workdir):
    agp = run_agp(workdir, "ref.fa", "scaf.r-f.fa", "r-f_test")
    assert agp == [
        "ntJoin0\t1\t1981\t1\tW\t1_r\t1\t1981\t-",
        "ntJoin0\t1982\t2001\t2\tN\t20\tscaffold\tyes\talign_genus",
        "ntJoin0\t2002\t4330\t3\tW\t2_f\t1\t2329\t+",
    ]


def test_mx_f_f_agp(workdir):
    agp = run_agp(workdir, "ref.fa", "scaf.f-f.termN.unassigned.fa", "f-f_test")
    assert agp == [
        "ntJoin0\t1\t1981\t1\tW\t1_f\t5\t1985\t+",
        "ntJoin0\t1982\t2001\t2\tN\t20\tscaffold\tyes\talign_genus",
        "ntJoin0\t2002\t4330\t3\tW\t2_f\t1\t2329\t+",
        "unassigned:0-14\t1\t8\t1\tW\tunassigned\t3\t10\t+",
    ]


# -- overlap trimming (reference :199-220) --


def test_mx_f_f_overlap(workdir):
    paths = run_pair(
        workdir, "ref.fa", "scaf.f-f.overlapping.fa", "f-f_test_overlap",
        overlap="True",
    )
    assert paths[-1] == "ntJoin0\t1+:0-2033 20N 2+:34-2331"


def test_mx_f_r_overlap(workdir):
    paths = run_pair(
        workdir, "ref.fa", "scaf.f-r.overlapping.fa", "f-r_test_overlap",
        overlap="True",
    )
    assert paths[-1] == "ntJoin0\t1+:0-2033 20N 2-:0-2297"


def test_mx_f_r_overlap_agp(workdir):
    agp = run_agp(
        workdir, "ref.fa", "scaf.f-r.overlapping.fa", "f-r_test_overlap_agp"
    )
    assert agp == [
        "ntJoin0\t1\t2033\t1\tW\t1\t1\t2033\t+",
        "ntJoin0\t2034\t2053\t2\tN\t20\tscaffold\tyes\talign_genus",
        "ntJoin0\t2054\t4350\t3\tW\t2\t1\t2297\t-",
    ]


def test_mx_r_r_overlap(workdir):
    paths = run_pair(
        workdir, "ref.fa", "scaf.r-r.overlapping.fa", "f-r_test_overlap",
        overlap="True",
    )
    assert paths[-1] == "ntJoin0\t1-:66-2099 20N 2-:0-2297"


# -- parameter behaviour pins (not in the reference suite) --


def test_min_gap_parameter(workdir):
    paths = run_pair(workdir, "ref.fa", "scaf.f-f.fa", "g_test", overlap="False",
                     g=100)
    assert paths == ["ntJoin0\t1_f+:0-1981 100N 2_f+:0-2329"]


def test_max_gap_parameter(workdir):
    paths = run_pair(
        workdir, "ref.multiple.fa", "scaf.multiple.fa", "G_test",
        window=500, n=1, overlap="False", G=50,
    )
    # estimated gaps (100N / 124N in the unclamped test) clamp to G=50
    got = {p.split("\t")[1] for p in paths}
    assert got == {"2_1_p+:0-2492 50N 2_2_n-:0-2574", "1_1_p+:0-1744 50N 1_2_p+:0-1844"}


def test_target_weight(workdir):
    # heavier target than reference flips the max-weight assembly used for
    # path orientation; the f-f case is symmetric so output is unchanged
    paths = launch(
        workdir, "tw_test",
        "target=scaf.f-f.fa", "target_weight=3", "references=ref.fa",
        "reference_weights=2", "prefix=tw_test", "k=32", "w=1000", "n=2",
        "overlap=False",
    )
    assert paths == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def test_no_shared_minimizers(workdir, tmp_path):
    """Unrelated reference: nothing scaffolds, everything lands unassigned."""
    import numpy as np

    rng = np.random.default_rng(99)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=5000))
    (workdir / "unrelated.fa").write_text(f">u\n{seq}\n")
    paths = run_pair(workdir, "unrelated.fa", "scaf.f-f.fa", "none_test",
                     overlap="False")
    assert paths == []
    unassigned = (workdir / "scaf.f-f.fa.k32.w1000.n2.unassigned.scaffolds.fa").read_text()
    assert ">1_f:0-1981" in unassigned and ">2_f:0-2329" in unassigned


def test_backend_jax_e2e(workdir):
    """One full pipeline run through the JAX sketch backend (CPU)."""
    cmd = [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
           "backend=jax", "target=scaf.f-f.fa", "target_weight=1",
           "references=ref.fa", "reference_weights=2", "prefix=jaxbe",
           "k=32", "w=1000", "n=2", "overlap=False"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lines = [ln.strip() for ln in (workdir / "jaxbe.path").read_text().splitlines()
             if ln.startswith("ntJoin")]
    assert lines == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def test_backend_jax_mesh_e2e(workdir):
    """Full pipeline with backend=jax while 8 virtual CPU devices are
    visible: one process drives the first device and the path matches the
    single-device run's."""
    cmd = [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
           "backend=jax", "target=scaf.f-f.fa", "target_weight=1",
           "references=ref.fa", "reference_weights=2", "prefix=meshbe",
           "k=32", "w=1000", "n=2", "overlap=False"]
    env = dict(
        os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    res = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lines = [ln.strip() for ln in (workdir / "meshbe.path").read_text().splitlines()
             if ln.startswith("ntJoin")]
    assert lines == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]


def _run_with_index(workdir, prefix, index_backend, *args):
    cmd = [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
           "backend=numpy", f"index_backend={index_backend}", *args,
           f"prefix={prefix}"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr + res.stdout


@pytest.mark.parametrize(
    "ref,target,extra",
    [
        ("ref.fa", "scaf.f-f.fa", ("w=1000", "n=2", "overlap=False", "agp=True")),
        ("ref.multiple.fa", "scaf.misassembled.f-f.r-r.fa",
         ("w=500", "n=1", "overlap=False")),
        ("ref.fa", "scaf.f-r.overlapping.fa", ("w=1000", "n=2", "overlap=True")),
    ],
)
def test_device_index_byte_equal(workdir, ref, target, extra):
    """index_backend=device: every artifact byte-equal to the host path.

    The device shared-index/edge-tally (ops/device_index.py) replaces the
    host filters (VERDICT round-1 item 3); .path/.mx.dot/.agp must not move
    by a byte, including DOT edge order and float weight formatting.
    """
    base_args = (f"target={target}", "target_weight=1", f"references={ref}",
                 "reference_weights=2", "k=32", *extra)
    _run_with_index(workdir, "hostidx", "host", *base_args)
    host_art = {}
    for suffix in (".path", ".mx.dot", ".agp"):
        p = workdir / ("hostidx" + suffix)
        if p.exists():
            host_art[suffix] = p.read_text()
    _run_with_index(workdir, "devidx", "device", *base_args)
    for suffix, want in host_art.items():
        got = (workdir / ("devidx" + suffix)).read_text()
        assert got == want.replace("hostidx", "devidx"), f"{suffix} differs"


def test_device_index_fractional_weights_byte_equal(workdir):
    """reference_weights='0.1 0.3' (not f32-exact): the device escalating
    filter must refuse f32 comparison and fall back to the host pass, so
    index_backend=device stays byte-equal to host (round-4 verdict item 3;
    reference filter semantics /root/reference/bin/ntjoin.py:70-78)."""
    base_args = (
        "target=scaf.f-f.fa", "target_weight=1",
        "references=ref.fa scaf.f-f.copy.fa", "reference_weights=2.3 0.1",
        "k=32", "w=1000", "n=1", "overlap=False",
    )
    _run_with_index(workdir, "fw_host", "host", *base_args)
    host_path = (workdir / "fw_host.path").read_text()
    host_dot = (workdir / "fw_host.mx.dot").read_text()
    assert "ntJoin0" in host_path  # the run actually scaffolds
    _run_with_index(workdir, "fw_dev", "device", *base_args)
    assert (workdir / "fw_dev.path").read_text() == host_path.replace(
        "fw_host", "fw_dev"
    )
    assert (workdir / "fw_dev.mx.dot").read_text() == host_dot.replace(
        "fw_host", "fw_dev"
    )


def test_backend_jax_device_index_e2e(workdir):
    """Full device-routed CI path: backend=jax sketch + index_backend=device
    graph passes (sketch through device index/CC/paths) on the golden f-f
    fixture — byte contract of reference tests/ntjoin_test.py:81-111
    (round-4 verdict item 9)."""
    cmd = [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
           "backend=jax", "index_backend=device", "target=scaf.f-f.fa",
           "target_weight=1", "references=ref.fa", "reference_weights=2",
           "prefix=jaxdev", "k=32", "w=1000", "n=2", "overlap=False"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr + res.stdout
    lines = [ln.strip() for ln in
             (workdir / "jaxdev.path").read_text().splitlines()
             if ln.startswith("ntJoin")]
    assert lines == ["ntJoin0\t1_f+:0-1981 20N 2_f+:0-2329"]
