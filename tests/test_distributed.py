"""Multi-process jax.distributed tests on the CPU backend.

The distributed pipeline is a product surface (``parallel/pipeline.py``,
reachable via ``ntjoin-tpu assemble coordinator=... n_procs=...
process_id=...``); these tests drive it end-to-end and assert artifact
byte-equality with the single-process pipeline.
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from ntjoin_tpu.parallel.distributed import initialize, global_mesh
pid = int(sys.argv[1])
initialize({coord!r}, 2, pid, local_device_count=4)
mesh = global_mesh()
assert mesh.devices.size == 8, mesh.devices.size
# cross-process psum smoke: per-device values 10+pid summed over the mesh
arr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("shard")),
    np.full(len(jax.local_devices()), 10 + pid, dtype=np.int32), (8,),
)
total = int(jax.jit(lambda x: x.sum())(arr))
print("TOTAL", total, flush=True)
"""


@pytest.mark.parametrize("coord,pid,env,card", [
    ("localhost:1234", 3, {}, 3),  # one host: the global id is the local rank
    ("127.0.0.1:1234", 0, {}, 0),
    ("node7:1234", 5, {}, None),  # several hosts, no local rank: no pin
    ("node7:1234", 5, {"LOCAL_RANK": "1"}, 1),  # the launcher's local rank
    ("node7:1234", 5, {"SLURM_LOCALID": "2"}, 2),
    ("localhost:1234", 2, {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}, 2),
    ("localhost:1234", 2, {"CUDA_VISIBLE_DEVICES": "3"}, None),  # past the list
    ("node7:1234", 9, {"LOCAL_RANK": "1", "CUDA_VISIBLE_DEVICES": "4,5"}, 1),
])
def test_local_card_pins_only_a_card_the_process_has(coord, pid, env, card):
    from ntjoin_tpu.parallel.distributed import local_card

    assert local_card(coord, pid, env) == card


def test_two_process_mesh(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO, coord=coord))
    env = dict(os.environ)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        outs.append(out)
    # per-device values: 4 devices with 10, 4 with 11 -> 84
    for out in outs:
        assert "TOTAL 84" in out


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_single_truth(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "ntjoin_tpu.cli", "assemble", "-B",
         "backend=numpy", "target=scaf.f-f.fa", "target_weight=1",
         "references=ref.fa", "reference_weights=2", "prefix=single",
         "k=32", "w=1000", "n=2", "overlap=False", "agp=True"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
    )
    assert res.returncode == 0, res.stderr


def _assert_byte_equal(tmp_path, dist_prefix="dist"):
    for suffix in (".path", ".agp", ".mx.dot"):
        single = (tmp_path / ("single" + suffix)).read_text()
        dist = (tmp_path / (dist_prefix + suffix)).read_text()
        assert dist == single.replace("single", dist_prefix), f"{suffix} differs"


def test_two_process_scaffold_cli_byte_equal(tmp_path):
    """2-process CLI run (record shard -> sketch -> collective filter ->
    survivor exchange -> process-0 scaffold) produces artifacts byte-equal
    to the single-process pipeline."""
    import shutil

    ref_dir = "/root/reference/tests"
    for f in ("ref.fa", "scaf.f-f.fa"):
        shutil.copy(os.path.join(ref_dir, f), tmp_path / f)

    _run_single_truth(tmp_path)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ntjoin_tpu.cli", "assemble",
             "target=scaf.f-f.fa", "target_weight=1", "references=ref.fa",
             "reference_weights=2", "prefix=dist", "k=32", "w=1000", "n=2",
             "overlap=False", "agp=True",
             f"coordinator=localhost:{port}", "n_procs=2",
             f"process_id={pid}", "local_devices=4"],
            cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    _assert_byte_equal(tmp_path)
    # the assigned/unassigned/all scaffold trio is written like the
    # single-process CLI flow
    assert (tmp_path / "scaf.f-f.fa.k32.w1000.n2.all.scaffolds.fa").exists()


def test_single_process_pipeline_api_byte_equal(tmp_path):
    """coordinator=None runs the same pipeline code path single-process
    (the mode dryrun_multichip exercises on the virtual mesh)."""
    import shutil

    ref_dir = "/root/reference/tests"
    for f in ("ref.fa", "scaf.f-f.fa"):
        shutil.copy(os.path.join(ref_dir, f), tmp_path / f)

    _run_single_truth(tmp_path)

    script = tmp_path / "api.py"
    script.write_text(
        f"""
import os, sys
sys.path.insert(0, {REPO!r})
os.environ["JAX_PLATFORMS"] = "cpu"
os.chdir({str(tmp_path)!r})
from ntjoin_tpu.parallel.pipeline import DistributedConfig, distributed_assemble
cfg = DistributedConfig(
    target="scaf.f-f.fa", references=["ref.fa"], reference_weights=[2.0],
    target_weight=1.0, prefix="api", k=32, w=1000, n=2,
    scaffold_opts=dict(overlap=False, agp=True, verbose=False),
)
distributed_assemble(cfg)
print("API_DONE")
"""
    )
    res = subprocess.run(
        [sys.executable, str(script)],
        env=dict(os.environ), capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "API_DONE" in res.stdout
    _assert_byte_equal(tmp_path, "api")


def test_sharded_survive_matches_replicated():
    """The hash-bucket all-to-all verdict is bit-equal to the replicated
    all-gather oracle on the 8-device virtual mesh, and its per-device
    live buffer is O(total / n_devices), not O(total)."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ntjoin_tpu.parallel.distributed import (
        bucket_width_for_rows,
        distributed_survive,
        distributed_survive_sharded,
        global_mesh,
    )

    mesh = global_mesh()
    n_dev = mesh.devices.size
    assert n_dev == 8
    rng = np.random.default_rng(3)
    width = 512
    n_el = n_dev * width
    n_asm = 3
    # hashes with plenty of collisions: duplicates within and across asms
    lo = rng.integers(0, 700, n_el).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n_el, dtype=np.uint64).astype(np.uint32)
    # tie hi to lo so equal (lo, hi) pairs actually occur
    hi = (hi % np.uint32(5)) + lo
    asm = rng.integers(0, n_asm, n_el).astype(np.int32)
    alive = rng.random(n_el) < 0.9

    sharding = NamedSharding(mesh, P("shard", None))
    arrs = [
        jax.device_put(x.reshape(n_dev, width), sharding)
        for x in (lo, hi, asm, alive)
    ]
    ref = np.asarray(distributed_survive(mesh, *arrs, n_asm=n_asm))

    bw = bucket_width_for_rows(
        hi.reshape(n_dev, width), alive.reshape(n_dev, width), n_dev
    )
    got = np.asarray(
        distributed_survive_sharded(
            mesh, *arrs, n_asm=n_asm, bucket_width=bw
        )
    ).reshape(-1)
    assert (got == ref).all()

    # memory shape: the sharded path's per-device buffer (n_dev * bw) must
    # stay near total_alive / n_dev, far below the replicated n_dev * width
    per_dev_buffer = n_dev * bw
    assert per_dev_buffer < 2 * n_el // n_dev + 64
    assert per_dev_buffer < n_el // 2

    # determinism across mesh width: a 4-device mesh over the same stream
    # gives the same verdict per entry
    from ntjoin_tpu.parallel.mesh import make_mesh

    mesh4 = make_mesh(4)
    width4 = n_el // 4
    sharding4 = NamedSharding(mesh4, P("shard", None))
    arrs4 = [
        jax.device_put(x.reshape(4, width4), sharding4)
        for x in (lo, hi, asm, alive)
    ]
    bw4 = bucket_width_for_rows(
        hi.reshape(4, width4), alive.reshape(4, width4), 4
    )
    got4 = np.asarray(
        distributed_survive_sharded(
            mesh4, *arrs4, n_asm=n_asm, bucket_width=bw4
        )
    ).reshape(-1)
    assert (got4 == ref).all()
