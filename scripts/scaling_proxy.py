"""Virtual-mesh scaling proxy (BASELINE scaling axis, CPU-honest caveat).

This proxy runs on the 8-device VIRTUAL CPU mesh
(--xla_force_host_platform_device_count=8).  What is meaningful on such a
mesh and recorded here:

* shard BALANCE of the sequence-parallel sketch tiling (per-shard owned
  window counts) at 1/2/4/8 devices — the quantity that determines real
  multi-device efficiency, independent of the CPU backend;
* wall time per mesh size (all 8 virtual devices share the host's cores,
  so wall is a partitioning-overhead signal, NOT a device measurement);
* the hash-sharded distributed filter's per-device buffer entries vs the
  replicated all-gather oracle (memory scaling), plus verdict equality.

Prints ONE JSON line.
"""
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import numpy as np


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ntjoin_tpu.ops.nthash_np import sketch_codes
    from ntjoin_tpu.parallel.mesh import (
        _tile_record, make_mesh, sketch_sharded,
    )

    k, w = 32, 250
    n = int(os.environ.get("SCALE_PROXY_BASES", 4_000_000))
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for s in rng.integers(0, n - 3000, 6):
        codes[s : s + 2500] = 4  # interior N runs: stream-split must stay exact

    ref = sketch_codes(codes, k, w)
    out = {"bases": n, "k": k, "w": w, "devices": {}}
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd)
        got = sketch_sharded(codes, k, w, mesh)  # warm (compile)
        assert got.positions.tolist() == ref.positions.tolist(), nd
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            sketch_sharded(codes, k, w, mesh)
            walls.append(time.monotonic() - t0)
        _, _, _, own = _tile_record(codes, nd, k, w)
        own = own.astype(np.int64)
        balance = float(own.max() / max(own.mean(), 1e-9))
        out["devices"][nd] = {
            "wall_s": round(min(walls), 3),
            "windows_per_shard": own.tolist(),
            "balance_max_over_mean": round(balance, 4),
        }

    # distributed filter memory scaling: sharded buckets vs replication
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ntjoin_tpu.parallel.distributed import (
        bucket_width_for_rows,
        distributed_survive,
        distributed_survive_sharded,
    )

    mesh = make_mesh(8)
    width = 4096
    n_el = 8 * width
    lo = rng.integers(0, 1 << 32, n_el, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n_el, dtype=np.uint64).astype(np.uint32)
    asm = rng.integers(0, 3, n_el).astype(np.int32)
    alive = np.ones(n_el, bool)
    sharding = NamedSharding(mesh, P("shard", None))
    arrs = [
        jax.device_put(x.reshape(8, width), sharding)
        for x in (lo, hi, asm, alive)
    ]
    bw = bucket_width_for_rows(
        hi.reshape(8, width), alive.reshape(8, width), 8
    )
    t0 = time.monotonic()
    got = np.asarray(
        distributed_survive_sharded(mesh, *arrs, n_asm=3, bucket_width=bw)
    ).reshape(-1)
    sharded_wall = time.monotonic() - t0
    t0 = time.monotonic()
    rep = np.asarray(distributed_survive(mesh, *arrs, n_asm=3))
    rep_wall = time.monotonic() - t0
    assert (got == rep).all()
    out["filter"] = {
        "total_entries": n_el,
        "per_device_buffer_sharded": 8 * bw,
        "per_device_buffer_replicated": n_el,
        "memory_ratio": round(8 * bw / n_el, 3),
        "sharded_wall_s": round(sharded_wall, 3),
        "replicated_wall_s": round(rep_wall, 3),
        "verdicts_equal": True,
    }
    out["caveat"] = (
        "8 virtual CPU devices on 2 host cores: wall is partitioning "
        "overhead, not chip speedup; balance/memory columns are the "
        "hardware-independent scaling signal"
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
