"""Parity: GPU sketch kernels (Pallas interpret mode on the CPU) vs the
NumPy oracle, through the kernels themselves and the batched wrapper."""
import numpy as np
import pytest

from ntjoin_tpu.ops import sketch_gpu as sg
from ntjoin_tpu.ops.nthash_np import canonical_hashes, sketch_codes


def _assert_same(got, codes, k, w):
    ref = sketch_codes(codes, k, w)
    assert got.positions.tolist() == ref.positions.tolist()
    assert got.hashes.tolist() == ref.hashes.tolist()


def _check(records, k, w):
    for codes, sk in zip(records, sg.sketch_records_gpu(records, k, w, True)):
        _assert_same(sk, codes, k, w)


@pytest.mark.parametrize("seed,k,w", [(0, 15, 10), (1, 32, 25), (2, 21, 40)])
def test_random_parity(seed, k, w):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    _assert_same(sg.sketch_codes_gpu(codes, k, w, interpret=True), codes, k, w)


@pytest.mark.parametrize("k", [15, 32])
def test_hash_kernel_matches_oracle(k):
    """Row r of lane c = canonical hash + validity of the k-mer ending at
    base c*L + r, for every row the lane reads (halo included)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=9_000).astype(np.int8)
    codes[[100, 2_000, 2_001, 5_555]] = 4
    lay = sg._layout(codes.shape[0], k, 10)
    buf = np.full(lay.buflen, 4, np.int8)
    buf[: codes.shape[0]] = codes
    lo, hi, val = (np.asarray(a) for a in sg._hash(jnp.asarray(buf), k, lay, True))
    canon, valid = canonical_hashes(buf.astype(np.uint8), k)
    for c in (0, 1, lay.C // 2, lay.C - 1):
        ends = c * lay.L + np.arange(k - 1, lay.R)
        starts = ends - (k - 1)
        ok = valid[starts]
        got = lo[k - 1:, c].astype(np.uint64) | (hi[k - 1:, c].astype(np.uint64) << 32)
        assert (val[k - 1:, c] == ok).all()
        assert (got[ok] == canon[starts][ok]).all()
        assert not val[: k - 1, c].any()  # partial k-mers at the lane top


def test_window_kernel_marks_distinct_argmins():
    """The marks are exactly the distinct window argmins of the oracle."""
    import jax.numpy as jnp

    from ntjoin_tpu.ops.nthash_np import _window_lexmin

    rng = np.random.default_rng(3)
    k, w = 15, 12
    codes = rng.integers(0, 4, size=7_000).astype(np.int8)
    lay = sg._layout(codes.shape[0], k, w)
    buf = np.full(lay.buflen, 4, np.int8)
    buf[: codes.shape[0]] = codes
    lo, hi, val = sg._hash(jnp.asarray(buf), k, lay, True)
    mark = np.asarray(sg._window(lo, hi, val, k, w, lay, True))
    canon, _ = canonical_hashes(codes.astype(np.uint8), k)
    expect = np.unique(_window_lexmin(canon, w))
    assert np.flatnonzero(mark).tolist() == expect.tolist()


def test_parity_with_ns():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    for start, length in [(500, 3), (10_000, 200), (30_000, 17), (59_990, 10)]:
        codes[start : start + length] = 4
    _assert_same(sg.sketch_codes_gpu(codes, 15, 10, True), codes, 15, 10)


def test_repeat_tiebreaks():
    codes = np.tile(np.array([0, 1, 2, 3], dtype=np.uint8), 12_000)
    _assert_same(sg.sketch_codes_gpu(codes, 8, 16, True), codes, 8, 16)


def test_batched_records_parity():
    """One device call over many records == per-record oracle sketches."""
    rng = np.random.default_rng(33)
    records = [
        rng.integers(0, 4, size=ln).astype(np.uint8)
        for ln in [5000, 120, 9000, 31, 4000, 2500]  # incl. sub-k, sub-w
    ]
    records[0][100:160] = 4  # N run inside one record
    _check(records, 15, 10)


def test_batched_dirty_records():
    rng = np.random.default_rng(44)
    records = []
    for ln in [9000, 7000]:
        codes = rng.integers(0, 4, size=ln).astype(np.uint8)
        codes[ln // 3 : ln // 3 + 120] = 4  # interior N run
        records.append(codes)
    _check(records, 15, 10)


def test_segmented_n_rich_records():
    """N-containing records split into clean segments (device) plus host
    junction patches; the union by position equals the oracle."""
    rng = np.random.default_rng(46)
    records = []
    for ln in [9000, 12000]:
        codes = rng.integers(0, 4, size=ln).astype(np.uint8)
        # several interior runs incl. short inter-run segments (< w+k-1)
        for start, rl in [(500, 40), (550, 30), (4000, 200), (ln - 300, 5)]:
            codes[start : start + rl] = 4
        records.append(codes)
    _check(records, 15, 10)


def test_pathological_n_density_routes_to_xla(monkeypatch):
    """When junction work rivals the record, the whole record goes to the
    XLA program of ops/sketch_jax — still exact, still on the device."""
    import ntjoin_tpu.ops.sketch_jax as sj

    calls = []
    orig = sj.sketch_codes_jax

    def spy(codes, k, w):
        calls.append(codes.shape[0])
        return orig(codes, k, w)

    monkeypatch.setattr(sj, "sketch_codes_jax", spy)
    monkeypatch.setattr(sg, "_PATCH_WORK_MIN", 1000)
    rng = np.random.default_rng(47)
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    codes[::25] = 4  # every segment shorter than w + k - 1
    clean = rng.integers(0, 4, size=5_000).astype(np.uint8)
    _check([codes, clean], 15, 16)
    assert calls == [60_000]


def test_batched_clean_records():
    rng = np.random.default_rng(45)
    records = [
        rng.integers(0, 4, size=ln).astype(np.uint8)
        for ln in [8000, 40, 6000, 2000, 9]
    ]
    _check(records, 15, 10)


def test_equal_hash_run_parity():
    """Homopolymers and microsatellites: every k-mer of a run can share
    one canonical hash, so the argmin slides one position per window —
    inside single records and at record edges."""
    rng = np.random.default_rng(77)
    k, w = 15, 16
    codes = rng.integers(0, 4, size=60_000).astype(np.uint8)
    codes[5_000:5_200] = 1  # poly-C
    codes[20_000:20_060] = 3  # short poly-T
    codes[40_000:40_100:2] = 0  # AT: one canonical hash for both phases
    codes[40_001:40_101:2] = 3
    codes[52_000:52_400:2] = 0  # AC: distinct phase hashes
    codes[52_001:52_401:2] = 1
    _check([codes, codes[:30_000], codes[30_000:], codes[4_990:5_230]], k, w)


def test_periodic_repeat():
    rng = np.random.default_rng(9)
    k, w = 15, 64
    codes = rng.integers(0, 4, size=70_000).astype(np.uint8)
    codes[30_000:30_600:2] = 0  # 600 bp AC repeat
    codes[30_001:30_601:2] = 1
    _check([codes], k, w)


def test_cap_retry(monkeypatch):
    """A repeat-dense batch emits past the layout's cap: the batch is run
    again under a cap that holds every emission, exactly."""
    runs = []
    orig = sg._run_batch

    def spy(batch, k, w, interpret, cap):
        runs.append(cap)
        return orig(batch, k, w, interpret, cap)

    monkeypatch.setattr(sg, "_run_batch", spy)
    codes = np.ones(9_000, np.uint8)  # homopolymer: every window emits
    _check([codes], 15, 10)
    assert len(runs) == 2 and runs[1] > runs[0]


def test_batch_split_parity(monkeypatch):
    """A small batch size splits the records over several device programs;
    the outputs equal the oracle."""
    monkeypatch.setattr(sg, "_BATCH_BASES", 16_000)
    rng = np.random.default_rng(60)
    records = [
        rng.integers(0, 4, size=ln).astype(np.uint8)
        for ln in [9000, 8000, 7000, 6000]
    ]
    _check(records, 15, 10)


def test_long_record_pieces(monkeypatch):
    """A clean stretch longer than a batch is cut into pieces that overlap
    by w + k - 2 bases; their union by position is exact, for a clean
    record and for a long segment of an N-containing one."""
    monkeypatch.setattr(sg, "_BATCH_BASES", 5_000)
    rng = np.random.default_rng(61)
    clean = rng.integers(0, 4, size=23_456).astype(np.uint8)
    dirty = rng.integers(0, 4, size=20_000).astype(np.uint8)
    dirty[3_000:3_100] = 4
    _check([clean, dirty], 15, 10)


def test_giant_record_is_a_counted_host_route(monkeypatch):
    """Records at or past the int32 device-position cap go to the host
    sketcher, counted in host_routes; the other records stay on device."""
    from ntjoin_tpu.utils import routes

    calls = []

    def fake_host(codes, k, w):
        calls.append(codes.shape[0])
        return "HOST_SENTINEL"

    monkeypatch.setattr(sg, "_host_sketch", fake_host)
    small = np.random.default_rng(1).integers(0, 4, 40_000).astype(np.uint8)
    giant = np.zeros(sg._I32_CAP, dtype=np.int8)  # untouched pages
    routes.reset()
    out = sg.sketch_records_gpu([small, giant], 15, 10, interpret=True)
    assert out[1] == "HOST_SENTINEL" and calls == [giant.shape[0]]
    assert routes.host_routes() == 1
    _assert_same(out[0], small, 15, 10)


def test_empty_and_degenerate_records():
    rng = np.random.default_rng(8)
    records = [
        np.zeros(0, np.uint8),
        np.full(500, 4, np.uint8),  # all N
        rng.integers(0, 4, size=14).astype(np.uint8),  # shorter than k
        rng.integers(0, 4, size=23).astype(np.uint8),  # exactly w + k - 1
    ]
    records[3] = records[3].copy()
    _check(records, 15, 9)


@pytest.mark.gpu
def test_compiled_kernels_match_native(gpu):
    """The kernels as compiled for the card == the native sketcher on
    random, repeat and N-run records (the interpret-mode tests above
    cannot see what the GPU compiler does)."""
    from ntjoin_tpu.io.native import sketch_codes_native

    rng = np.random.default_rng(12)
    recs = [rng.integers(0, 4, size=ln).astype(np.uint8)
            for ln in (3_000_000, 700_000, 50_000, 999)]
    recs[0][1_000_000:1_002_000] = 2
    recs[1][300_000:300_700] = 4
    for k, w in ((32, 1000), (15, 10)):
        for codes, sk in zip(recs, sg.sketch_records_gpu(recs, k, w)):
            ref = sketch_codes_native(codes, k, w)
            assert sk.positions.tolist() == ref.positions.tolist()
            assert sk.hashes.tolist() == ref.hashes.tolist()
