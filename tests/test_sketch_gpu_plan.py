"""Host side of the GPU sketch: layout, packing, segmentation, batching."""
import numpy as np
import pytest

from ntjoin_tpu.ops import sketch_gpu as sg


@pytest.mark.parametrize("n,k,w", [(100, 15, 10), (70_000, 15, 10),
                                   (16_000_000, 32, 1000),
                                   (sg._BATCH_BASES + 40, 32, 1000)])
def test_layout_covers_the_batch(n, k, w):
    """Every k-mer start has a lane, each lane reads every base its
    windows need, buffers stay inside int32 and the grid is whole."""
    lay = sg._layout(n, k, w)
    assert lay.L == sg._BLOCKS * w
    assert lay.C % sg._LANES == 0 and lay.C * lay.L >= n - k + 1
    assert lay.R >= lay.L + w + k - 1 and lay.R % sg._UNROLL == 0
    assert lay.buflen == (lay.C - 1) * lay.L + lay.R
    assert lay.C * lay.L + lay.C < 2**31


def test_lane_buckets_share_programs():
    """Lane counts snap to eight steps per octave: at most 1/8 padding,
    and nearby batch sizes share one compiled program."""
    for chunks in range(1, 5_000, 7):
        c = sg._lanes_for(chunks)
        assert c >= max(chunks, sg._LANES) and c % sg._LANES == 0
        assert c <= max(sg._LANES, chunks * 9 // 8 + sg._LANES)
    assert sg._lanes_for(16_700) == sg._lanes_for(17_000)


def test_batches_of_a_call_share_one_layout(monkeypatch):
    """Every batch of one call is laid out for the largest of them, so a
    call loads one program however its records fall into batches."""
    monkeypatch.setattr(sg, "_BATCH_BASES", 16_000)
    lays = []
    orig = sg._plan_batch

    def spy(*args, **kw):
        b = orig(*args, **kw)
        lays.append(b.lay)
        return b

    monkeypatch.setattr(sg, "_plan_batch", spy)
    monkeypatch.setattr(sg, "_run_batch", lambda *a: None)
    one = sg.Sketch(np.zeros(1, np.int64), np.zeros(1, np.uint64))
    monkeypatch.setattr(sg, "_finish_batch", lambda b, *a: [one] * len(b.pieces))
    rng = np.random.default_rng(5)
    records = [rng.integers(0, 4, size=ln).astype(np.uint8)
               for ln in (15_000, 9_000, 9_000, 3_000, 40_000)]
    sg.sketch_records_gpu(records, 15, 10)
    assert len(lays) >= 3 and len(set(lays)) == 1


def test_cap_for_margin():
    lay = sg._layout(10_000_000, 32, 1000)
    cap = sg._cap_for(lay, 1000)
    assert cap >= 2.5 * lay.C * lay.L / 1000 and cap >= 4096


def test_prep_codes_paints_runs():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=203).astype(np.int8)
    packed = np.zeros(64, np.uint8)
    sg._pack2_host(codes, packed, 2)
    runs = [(8, 11), (100, 140), (211, 256)]
    starts = np.full(8, 256, np.int32)
    ends = np.full(8, 256, np.int32)
    starts[:3] = [s for s, _ in runs]
    ends[:3] = [e for _, e in runs]
    out = np.asarray(sg._prep_codes(jnp.asarray(packed), starts, ends))
    expect = np.zeros(256, np.int8)
    expect[8:211] = codes
    for s, e in runs:
        expect[s:e] = 4
    assert out.tolist() == expect.tolist()


def test_pack2_host_python_path_matches_native(monkeypatch):
    from ntjoin_tpu.io import native

    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, size=1_003).astype(np.int8)
    a = np.zeros(260, np.uint8)
    sg._pack2_host(codes, a, 3)
    monkeypatch.setattr(native, "available", lambda: False)
    b = np.zeros(260, np.uint8)
    sg._pack2_host(codes, b, 3)
    assert a.tolist() == b.tolist()
    unpacked = (b[3:][:, None] >> np.arange(0, 8, 2)) & 3
    assert unpacked.reshape(-1)[:1_003].tolist() == (codes & 3).tolist()


def test_invalid_runs_and_segments():
    codes = np.array([4, 4, 0, 1, 4, 2, 3, 3, 4], np.int8)
    runs = sg._invalid_runs(codes, 10)
    assert runs == [(10, 12), (14, 15), (18, 19)]
    assert sg._invalid_runs(np.zeros(5, np.int8), 0) == []
    local = sg._invalid_runs(codes, 0)
    assert sg._segments_of(9, local) == [(2, 4), (5, 8)]


def test_patch_plan_covers_junction_windows():
    """Patch windows are exactly the stream windows no long segment holds."""
    k, w = 5, 4
    n = 60
    runs = [(20, 23), (30, 31)]
    segs, nks, offs, patch_ivs, work = sg._patch_plan(n, runs, k, w)
    assert segs == [(0, 20), (23, 30), (31, 60)]
    n_stream = int(offs[-1])
    covered = set()
    for i, (s, e) in enumerate(segs):
        if e - s >= w + k - 1:
            covered.update(range(int(offs[i]), int(offs[i]) + nks[i] - w + 1))
    patched = set()
    for a, b in patch_ivs:
        patched.update(range(a, b + 1))
    assert covered | patched == set(range(n_stream - w + 1))
    assert not covered & patched
    assert work == sum(b - a + w for a, b in patch_ivs)


@pytest.mark.parametrize("s,e", [(0, 23_456), (7, 15_007), (100, 4_130)])
def test_pieces_hold_every_window(monkeypatch, s, e):
    monkeypatch.setattr(sg, "_BATCH_BASES", 5_000)
    k, w = 15, 10
    span = w + k - 1  # bases of one window
    pieces = sg._pieces(s, e, k, w)
    assert all(b - a <= sg._BATCH_BASES and b - a >= span for a, b in pieces)
    for t in range(s, e - span + 1, 37):
        assert any(a <= t and t + span <= b for a, b in pieces), t


def test_plan_batch_layout():
    """Pieces start 4-aligned with >= k-1 invalid bases after each, and
    the invalid-run list paints separators and the buffer tail."""
    rng = np.random.default_rng(2)
    pieces = [(i, 0, rng.integers(0, 4, size=ln).astype(np.int8))
              for i, ln in enumerate([101, 7, 50])]
    b = sg._plan_batch(pieces, 15, 10)
    assert (b.offsets % 4 == 0).all()
    ends = b.offsets + np.array([101, 7, 50])
    assert (b.offsets[1:] - ends[:-1] >= 14).all()
    packed, starts, ends_r = b.inputs
    assert packed.shape[0] * 4 >= b.lay.buflen
    live = starts < packed.shape[0] * 4
    assert starts[live].tolist()[:3] == ends.tolist()
    assert ends_r[live][-1] == packed.shape[0] * 4
