"""The product-facing distributed scaffolding pipeline.

Record-shard -> local sketch -> collective global uniqueness/intersection
verdict -> survivor exchange -> host-0 scaffold.  This is the framework's
replacement for the reference's single-node parallelism (per-assembly
``indexlr`` processes, ``/root/reference/ntJoin:204-205``, and the
``multiprocessing.Pool`` over components, ``bin/ntjoin.py:164-176``):
assemblies' records are sharded round-robin across processes, each process
sketches only its records, the uniqueness+intersection verdict rides a
hash-bucket all-to-all (``distributed_survive_sharded`` — per-device live
memory O(total / n_devices), never the replicated multiset), and only the
*surviving* minimizers — a small fraction of the stream — are exchanged
before process 0 runs the (cheap, irregular) graph/path/emit stages.

Determinism: the verdict is a pure function of the gathered multiset and
the surviving streams are restored to per-assembly stream order before
scaffolding, so artifacts are byte-identical to a single-process run at
any process count (``tests/test_distributed.py``).

Runs without GPUs too: each process forces the CPU backend and a virtual
device count, with the coordinator on localhost.  With ``coordinator=None``
the same code path runs single-process over the local devices (used by
``__graft_entry__.dryrun_multichip``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class DistributedConfig:
    """Launch parameters for one process of a distributed run."""

    target: str
    references: list[str]
    reference_weights: list[float]
    prefix: str
    target_weight: float = 1.0
    k: int = 32
    w: int = 1000
    n: int = 1
    coordinator: str | None = None  # None = single-process
    num_processes: int = 1
    process_id: int = 0
    local_device_count: int | None = None
    # scaffolding options forwarded to ScaffoldConfig
    scaffold_opts: dict = field(default_factory=dict)


def _pack_rows(x: np.ndarray, fill, n_rows: int, width: int) -> np.ndarray:
    buf = np.full(n_rows * width, fill, x.dtype)
    buf[: x.shape[0]] = x
    return buf.reshape(n_rows, width)


def distributed_assemble(cfg: DistributedConfig, sketch_fn=None) -> None:
    """Run one process of the distributed scaffolding pipeline.

    Every process calls this; artifacts are written by process 0 only.
    ``sketch_fn(codes, k, w) -> Sketch`` defaults to the best local host
    backend (each process sketches its own record shard on the host; the
    devices carry the collective verdict).
    """
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ntjoin_tpu.io.fasta import read_fasta
    from ntjoin_tpu.parallel.distributed import (
        bucket_width_for_rows,
        distributed_survive_sharded,
        global_mesh,
        initialize,
    )

    if cfg.coordinator is not None and cfg.num_processes > 1:
        initialize(
            cfg.coordinator,
            cfg.num_processes,
            cfg.process_id,
            local_device_count=cfg.local_device_count,
        )
    if sketch_fn is None:
        from ntjoin_tpu.io.native import available, sketch_codes_native

        if available():
            sketch_fn = sketch_codes_native
        else:
            from ntjoin_tpu.ops.nthash_np import sketch_codes

            sketch_fn = sketch_codes

    mesh = global_mesh()
    n_dev = mesh.devices.size
    n_local_dev = len(jax.local_devices())
    k, w = cfg.k, cfg.w
    fastas = list(cfg.references) + [cfg.target]
    n_asm = len(fastas)

    # every assembly is record-sharded round-robin across processes; each
    # process sketches only its records.  NO local dedup — uniqueness is a
    # global verdict, the whole point of the collective.
    names: dict[int, list[str]] = {}
    asms, ctgs, poss, los, his = [], [], [], [], []
    for a, fa in enumerate(fastas):
        recs = read_fasta(fa)
        names[a] = [r.id for r in recs]
        for ri, rec in enumerate(recs):
            if ri % cfg.num_processes != cfg.process_id:
                continue
            sk = sketch_fn(rec.codes, k, w)
            m = sk.hashes.shape[0]
            if m and int(sk.positions.max()) >= 2**31:
                # the survivor-exchange rows transport positions as int32;
                # wrapping would silently break the byte-identical-to-
                # single-process contract, so fail loudly (the
                # single-process host path handles such contigs fine)
                raise ValueError(
                    f"record {rec.id!r} has minimizer positions >= 2^31; "
                    "distributed mode cannot transport them — run "
                    "single-process for assemblies with >2.1 Gbp contigs"
                )
            asms.append(np.full(m, a, np.int32))
            ctgs.append(np.full(m, ri, np.int32))
            poss.append(sk.positions.astype(np.int32))
            los.append((sk.hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32))
            his.append((sk.hashes >> np.uint64(32)).astype(np.uint32))

    def cat(parts, dtype):
        return (
            np.concatenate(parts) if parts else np.empty(0, dtype)
        ).astype(dtype)

    asm_l, ctg_l = cat(asms, np.int32), cat(ctgs, np.int32)
    pos_l = cat(poss, np.int32)
    lo_l, hi_l = cat(los, np.uint32), cat(his, np.uint32)
    n_local = lo_l.shape[0]

    # agree on the per-device padded width
    counts = multihost_utils.process_allgather(np.array([n_local], np.int32))
    max_n = int(np.asarray(counts).max())
    width = max(64, -(-max_n // n_local_dev))
    width = 1 << (width - 1).bit_length()

    sharding = NamedSharding(mesh, P("shard", None))

    def mk(x):
        return jax.make_array_from_process_local_data(
            sharding, x, (n_dev, width)
        )

    alive = _pack_rows(np.ones(n_local, bool), False, n_local_dev, width)
    hi_rows = _pack_rows(hi_l, np.uint32(0), n_local_dev, width)
    # hash-sharded verdict (SURVEY hard-part 5): bucket capacity is the max
    # per-(device, bucket) count across processes — exact, no overflow path
    local_bw = bucket_width_for_rows(hi_rows, alive, n_dev)
    bw = int(
        np.asarray(
            multihost_utils.process_allgather(np.array([local_bw], np.int32))
        ).max()
    )
    verdict_sharded = distributed_survive_sharded(
        mesh,
        mk(_pack_rows(lo_l, np.uint32(0), n_local_dev, width)),
        mk(hi_rows),
        mk(_pack_rows(asm_l, np.int32(-1), n_local_dev, width)),
        mk(alive),
        n_asm,
        bucket_width=bw,
    )
    # the verdict stays sharded like the inputs: collect this process's rows
    row0 = cfg.process_id * n_local_dev
    mine_rows = np.zeros((n_local_dev, width), bool)
    for shard in verdict_sharded.addressable_shards:
        mine_rows[shard.index[0].start - row0] = np.asarray(shard.data)[0]
    mine = mine_rows.reshape(-1)[:n_local]

    # ship each process's SURVIVING stream entries to every process (hash
    # sets, not counts): pad to the agreed width for the host-level gather
    ns = int(mine.sum())
    cap = n_local_dev * width

    def pack_survivors(x, fill):
        buf = np.full(cap, fill, x.dtype)
        buf[:ns] = x[mine]
        return buf

    gathered = multihost_utils.process_allgather(
        np.stack(
            [
                pack_survivors(lo_l, np.uint32(0)).view(np.int32),
                pack_survivors(hi_l, np.uint32(0)).view(np.int32),
                pack_survivors(asm_l, np.int32(-1)),
                pack_survivors(ctg_l, np.int32(-1)),
                pack_survivors(pos_l, np.int32(-1)),
            ]
        )
    )
    if cfg.process_id != 0:
        return

    arr = np.asarray(gathered)
    if arr.ndim == 2:  # single-process allgather returns the local stack
        arr = arr[None]
    lo_g = arr[:, 0].reshape(-1).view(np.uint32)
    hi_g = arr[:, 1].reshape(-1).view(np.uint32)
    asm_g = arr[:, 2].reshape(-1)
    ctg_g = arr[:, 3].reshape(-1)
    pos_g = arr[:, 4].reshape(-1)
    keep = asm_g >= 0
    lo_g, hi_g = lo_g[keep], hi_g[keep]
    asm_g, ctg_g, pos_g = asm_g[keep], ctg_g[keep], pos_g[keep]
    hash_g = lo_g.astype(np.uint64) | (hi_g.astype(np.uint64) << np.uint64(32))

    from ntjoin_tpu.core.assembly import AssemblySketch
    from ntjoin_tpu.core.config import ScaffoldConfig
    from ntjoin_tpu.core.scaffolder import Scaffolder

    tsvs = [f"{fa}.k{k}.w{w}.tsv" for fa in fastas]
    weights = list(cfg.reference_weights) + [cfg.target_weight]
    cache = {}
    for a, tsv in enumerate(tsvs):
        sel = asm_g == a
        # restore the assembly's original stream order: emitted minimizer
        # positions are strictly increasing within a record
        order = np.lexsort((pos_g[sel], ctg_g[sel]))
        cache[tsv] = AssemblySketch.from_stream(
            tsv,
            weights[a],
            names[a],
            hash_g[sel][order],
            pos_g[sel][order].astype(np.int64),
            ctg_g[sel][order],
        )
    sc = ScaffoldConfig(
        references=tsvs[:-1],
        target=tsvs[-1],
        target_weight=cfg.target_weight,
        reference_weights=list(cfg.reference_weights),
        prefix=cfg.prefix,
        n=cfg.n,
        k=k,
        w=w,
        **cfg.scaffold_opts,
    )
    Scaffolder(sc, sketch_cache=cache).run()

    # the assigned/unassigned/all trio mirrors the single-process CLI
    base = f"{cfg.target}.k{k}.w{w}.n{cfg.n}"
    allf = f"{base}.all.scaffolds.fa"
    parts = [
        f"{base}.assigned.scaffolds.fa",
        f"{base}.unassigned.scaffolds.fa",
    ]
    if any(os.path.exists(p) for p in parts):
        with open(allf, "w", encoding="utf-8") as out:
            for part in parts:
                if os.path.exists(part):
                    with open(part, encoding="utf-8") as fh:
                        out.write(fh.read())
