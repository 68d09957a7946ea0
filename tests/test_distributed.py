"""Multi-process distribution smoke test: two jax.distributed processes on
CPU form one global mesh, shard blocks across processes, and exchange
ordering metadata (per-block compressed lengths) over the DCN collectives —
the multi-host story SURVEY §5 calls for (jax.distributed.initialize + DCN;
block independence makes payloads host-local, only lengths/checksums cross).

Runs each process as a subprocess (the coordinator is process 0)."""

import json
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"  # virtual CPU devices stand in for chips
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2").strip()
sys.path.insert(0, {repo!r})
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address={coord!r},
    num_processes=2,
    process_id={pid},
)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map
from compu_tpu.kernels.deflate_jax_v2 import encode_block_fixed_v2

assert jax.process_count() == 2
devices = np.asarray(jax.devices())  # global device list, both processes
mesh = Mesh(devices, ("dp",))

BLOCK = 1 << 14

def local_encode(blocks, lens):
    def one(args):
        block, n = args
        return encode_block_fixed_v2(block, n, depth=2)
    outs, metas = jax.lax.map(one, (blocks, lens))
    lens_g = jax.lax.all_gather(metas[:, 0], "dp", tiled=True)
    total = jax.lax.psum(jnp.sum(metas[:, 0]), "dp")
    return lens_g, total

step = jax.jit(shard_map(local_encode, mesh=mesh,
                         in_specs=(P("dp", None), P("dp")),
                         out_specs=(P(), P()), check_vma=False))

B = len(devices)
rng = np.random.default_rng(3)
host = rng.integers(65, 91, (B, BLOCK)).astype(np.uint8)
host[:, ::2] = 65  # compressible
lens = np.full(B, BLOCK, dtype=np.int32)

# Build the globally-sharded input from per-process local shards.
sharding = NamedSharding(mesh, P("dp", None))
n_local = B // 2
local = host[{pid} * n_local : ({pid} + 1) * n_local]
arrs = [
    jax.device_put(local[i : i + 1], d)
    for i, d in enumerate(mesh.local_devices)
]
blocks = jax.make_array_from_single_device_arrays((B, BLOCK), sharding, arrs)
lens_arrs = [
    jax.device_put(lens[{pid} * n_local + i : {pid} * n_local + i + 1], d)
    for i, d in enumerate(mesh.local_devices)
]
lens_g = jax.make_array_from_single_device_arrays(
    (B,), NamedSharding(mesh, P("dp")), lens_arrs)

out_lens, total = step(blocks, lens_g)
out_lens = np.asarray(out_lens)
assert int(np.asarray(total)) == int(out_lens.sum())
assert (out_lens > 0).all() and (out_lens < BLOCK).all()
print("RESULT " + json.dumps({{"pid": {pid}, "lens": out_lens.tolist()}}))
"""


def test_two_process_mesh_exchanges_ordering_metadata():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = []
    for pid in (0, 1):
        code = WORKER.format(repo=str(REPO), coord=coord, pid=pid)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", code],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )
    results = {}
    for pid, p in enumerate(procs):
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"process {pid} failed:\n{err[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("RESULT ")][-1]
        results[pid] = json.loads(line[len("RESULT "):])
    # Both processes observed the SAME global lengths (the all_gather).
    assert results[0]["lens"] == results[1]["lens"]
    assert len(results[0]["lens"]) == 4  # 2 processes x 2 local devices
