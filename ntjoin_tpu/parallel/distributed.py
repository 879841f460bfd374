"""Multi-process initialisation and the cross-process filter exchange.

The reference has no distribution at all (SURVEY §2.2); here several
processes run ``jax.distributed`` over one global 1-D mesh of every
process's devices, and the global uniqueness / intersection verdict rides
collectives over it (see ``parallel/mesh.py`` for the single-process
collectives).  Each process drives the card of its local rank.

Multi-process operation is testable without GPUs: each process forces the
CPU backend and a virtual device count, and the coordinator runs on
localhost (``tests/test_distributed.py``).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1", "[::1]")


def local_card(coordinator: str, process_id: int, env) -> int | None:
    """The card this process pins among its host's visible cards, or None.

    The local rank is the launcher's (``LOCAL_RANK`` and kin) when it sets
    one; else, with the coordinator on ``localhost``, every process shares
    this host and the global id is the local rank.  Otherwise (processes
    on several hosts, no local rank) nothing is pinned.  A rank past the
    cards ``CUDA_VISIBLE_DEVICES`` lists is not pinned either.
    """
    rank = next((int(env[v]) for v in _LOCAL_RANK_VARS
                 if env.get(v, "").isdigit()), None)
    if rank is None:
        if coordinator.rsplit(":", 1)[0] not in _LOCAL_HOSTS:
            return None
        rank = process_id
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and rank >= len([d for d in visible.split(",") if d]):
        return None
    return rank


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
) -> None:
    """Join the distributed runtime.  Call once, before any jax use.

    ``local_device_count`` gives each process that many virtual CPU
    devices (tests); otherwise the process is pinned to its card
    (``local_card``) — a JAX process reserves memory on every card it can
    see, so without the pin the second process on a host finds none left.
    """
    import os

    local_ids = None
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={local_device_count}"
        )
    else:
        card = local_card(coordinator, process_id, os.environ)
        local_ids = None if card is None else [card]
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_ids,
    )


def global_mesh(axis_name: str = "shard") -> Mesh:
    """1-D mesh over every device of every participating process."""
    return Mesh(np.array(jax.devices()), axis_names=(axis_name,))


def distributed_survive(mesh: Mesh, lo, hi, asm, alive, n_asm: int):
    """Replicated-gather reference implementation of the global verdict.

    Every shard all-gathers the FULL (hash, assembly) streams and derives
    the identical verdict — per-device memory is O(total), which is the
    replication the sharded design avoids.  The product path is
    ``distributed_survive_sharded`` (hash-bucket all-to-all, per-device
    memory O(total / n_devices)); this version is kept as the differential-
    testing oracle (``tests/test_distributed.py`` asserts bit-equality).

    A hash survives iff it occurs exactly once in every assembly's global
    multiset (reference semantics of ``read_minimizers`` +
    ``filter_minimizers``, ``bin/ntjoin_utils.py:152-193``).  Inputs are
    (n_devices, L) arrays sharded on the mesh axis; returns the FULL
    verdict, replicated, in (device, slot) order.
    """
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ntjoin_tpu.ops.device_index import survive_verdict_sorted

    def step(lo, hi, asm, alive):
        g_lo = jax.lax.all_gather(lo, "shard", tiled=True).reshape(-1)
        g_hi = jax.lax.all_gather(hi, "shard", tiled=True).reshape(-1)
        g_asm = jax.lax.all_gather(asm, "shard", tiled=True).reshape(-1)
        g_alive = jax.lax.all_gather(alive, "shard", tiled=True).reshape(-1)
        order, survive_sorted = survive_verdict_sorted(
            g_lo, g_hi, g_asm, ~g_alive, n_asm
        )
        return jnp.zeros(g_lo.shape[0], bool).at[order].set(survive_sorted)

    smap = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("shard", None),) * 4,
        out_specs=P(None),
        check_vma=False,
    )
    return jax.jit(smap)(lo, hi, asm, alive)


def bucket_width_for_rows(hi_rows: np.ndarray, alive_rows: np.ndarray,
                          n_buckets: int) -> int:
    """Exact per-(device, bucket) capacity needed by THIS process's rows.

    ``hi_rows``/``alive_rows`` are the (n_local_devices, width) packed
    arrays about to be sharded; the bucket of an entry is
    ``hi % n_buckets``.  The global capacity is the max of this value
    across processes (one tiny host all-gather in the pipeline), so the
    all-to-all buffers never overflow — no retry path needed.
    """
    mx = 1
    for hi, al in zip(hi_rows, alive_rows):
        b = (hi[al].astype(np.uint64) % np.uint64(n_buckets)).astype(np.int64)
        if b.size:
            mx = max(mx, int(np.bincount(b, minlength=n_buckets).max()))
    return mx


def distributed_survive_sharded(
    mesh: Mesh, lo, hi, asm, alive, n_asm: int, bucket_width: int
):
    """Hash-sharded global uniqueness+intersection verdict (the product
    path; SURVEY hard-part 5).

    Instead of replicating every shard's stream (``distributed_survive``),
    entries are exchanged by HASH BUCKET: device b owns bucket
    ``hi % n_devices == b``.  Each shard compacts its live entries into a
    (n_devices, bucket_width) send buffer, one ``all_to_all`` routes every
    bucket to its owner, the owner derives the per-bucket verdict locally
    (equal hashes always share a bucket, so the verdict is exact and a
    pure function of the bucket multiset — deterministic across mesh
    sizes), and a reverse ``all_to_all`` returns verdicts to the entries'
    home shards.  Per-device live memory is
    O(n_devices * bucket_width) ~ O(total / n_devices) for balanced
    hashes — the padded input row is never replicated.

    ``bucket_width`` must be >= the max per-(source device, bucket) entry
    count (use ``bucket_width_for_rows`` + a host max-reduce; exact, so
    there is no overflow path).  Returns the verdict sharded like the
    inputs: (n_devices, L) bool, P("shard", None).
    """
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ntjoin_tpu.ops.device_index import survive_verdict_sorted

    n_dev = mesh.devices.size
    bw = max(1, int(bucket_width))
    cap = n_dev * bw

    def step(lo, hi, asm, alive):
        lo, hi, asm, alive = lo[0], hi[0], asm[0], alive[0]
        width = lo.shape[0]
        i32 = jnp.int32
        bkt = (hi % jnp.uint32(n_dev)).astype(i32)
        key = jnp.where(alive, bkt, n_dev)  # dead entries sort past buckets
        sort_idx = jnp.argsort(key, stable=True)
        key_s = key[sort_idx]
        iota = jnp.arange(width, dtype=i32)
        first = jnp.where(
            jnp.concatenate([jnp.ones(1, bool), key_s[1:] != key_s[:-1]]),
            iota, 0,
        )
        rank = iota - jax.lax.cummax(first)  # rank within (device, bucket)
        dest_s = jnp.where(key_s < n_dev, key_s * bw + rank, cap)

        def scat(v, fill):
            return jnp.full(cap, fill, v.dtype).at[dest_s].set(
                v[sort_idx], mode="drop"
            )

        s_lo = scat(lo, jnp.uint32(0))
        s_hi = scat(hi, jnp.uint32(0))
        s_asm = scat(asm, i32(-1))
        s_alive = scat(alive, False)
        # where each original slot's entry went (for the verdict return)
        dest_of = jnp.full(width, cap, i32).at[sort_idx].set(dest_s)

        def exch(x):
            return jax.lax.all_to_all(
                x.reshape(n_dev, bw), "shard", 0, 0, tiled=True
            ).reshape(-1)

        g_lo, g_hi = exch(s_lo), exch(s_hi)
        g_asm, g_alive = exch(s_asm), exch(s_alive)
        order, surv_sorted = survive_verdict_sorted(
            g_lo, g_hi, g_asm, ~g_alive, n_asm
        )
        verdict = jnp.zeros(cap, bool).at[order].set(surv_sorted)
        back = exch(verdict)
        out = jnp.where(
            alive, back[jnp.minimum(dest_of, cap - 1)], False
        )
        return out[None]

    smap = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P("shard", None),) * 4,
        out_specs=P("shard", None),
        check_vma=False,
    )
    return jax.jit(smap)(lo, hi, asm, alive)
