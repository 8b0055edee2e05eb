"""Multi-process (multi-host-style) search via jax.distributed.

The reference has no distributed story at all; this validates the
device one on a single machine: two OS processes form a jax
cluster (CPU backend, 4 virtual devices each), the index is replicated
across the global mesh, each process feeds its process-local query
shard, and the merged counts must equal the single-process answer.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
proc_id = int(sys.argv[1])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:%PORT%",
    num_processes=2,
    process_id=proc_id,
)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from avxwindowfmindex_tpu import AlphabetType, IndexConfiguration, create_index
from avxwindowfmindex_tpu.parallel.dist import _sharded_count_allgather_fn, replicate_index
from avxwindowfmindex_tpu.search import SearchEngine

rng = np.random.default_rng(5)
seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2000).tobytes())
cfg = IndexConfiguration(4, 3, AlphabetType.DNA)
index = create_index(seq, cfg)

mesh = Mesh(np.array(jax.devices()), ("q",))
dev = replicate_index(index.to_device(), mesh)

engine = SearchEngine(index)
kmers = [seq[i * 7 : i * 7 + 12] for i in range(64)]
mat, lengths, n = engine.encode_kmers(kmers)

# each process provides its local slice of the globally-sharded batch
global_b = mat.shape[0]
local = slice(proc_id * global_b // 2, (proc_id + 1) * global_b // 2)
sharding = NamedSharding(mesh, P("q", None))
jm = jax.make_array_from_process_local_data(sharding, mat[local])
jl = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("q")), lengths[local]
)

from jax.experimental import multihost_utils

fn = _sharded_count_allgather_fn(mesh, max(0, mat.shape[1] - 3))
result = fn(dev, jm, jl)  # replicated over the global mesh
counts = np.asarray(
    multihost_utils.global_array_to_host_local_array(result, mesh, P())
)
want = np.asarray(engine.count(kmers), dtype=np.uint64)
np.testing.assert_array_equal(counts[:n].astype(np.uint64), want)
print(f"proc {proc_id} OK")
"""


# Locate + wide (hi/lo-u32) layout across process boundaries
# (the count test alone would leave the multi-host locate/merge story
# unexercised).
_WORKER_LOCATE = r"""
import os, sys
proc_id = int(sys.argv[1])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:%PORT%",
    num_processes=2,
    process_id=proc_id,
)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental import multihost_utils

from avxwindowfmindex_tpu import AlphabetType, IndexConfiguration, create_index
from avxwindowfmindex_tpu.parallel.dist import (
    _sharded_count_allgather64_fn,
    _sharded_resolve64_fn,
    _sharded_resolve_fn,
    replicate_index,
)
from avxwindowfmindex_tpu.search import SearchEngine

rng = np.random.default_rng(5)
seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2000).tobytes())
cfg = IndexConfiguration(4, 3, AlphabetType.DNA)
index = create_index(seq, cfg)

engine = SearchEngine(index)
kmers = [seq[i * 7 : i * 7 + 12] for i in range(64)]
ranges = engine.find_ranges(kmers)
s, e = ranges[:, 0], ranges[:, 1]
pos = np.where(s <= e, s, 0).astype(np.uint32)  # (64,), mesh-divisible
want_hits = engine.resolve_positions(pos.astype(np.uint64))

mesh = Mesh(np.array(jax.devices()), ("q",))
local = slice(proc_id * 32, (proc_id + 1) * 32)

# narrow locate: sharded backtrace+resolve, then a host allgather merge
dev = replicate_index(index.to_device(), mesh)
jp = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("q")), pos[local]
)
hits = _sharded_resolve_fn(mesh)(dev, jp)
got = np.asarray(multihost_utils.process_allgather(hits, tiled=True))
np.testing.assert_array_equal(got.astype(np.uint64), want_hits)

# wide (hi/lo-u32) layout across the same process mesh: count + locate
index._device_cache = None
dev64 = replicate_index(index.to_device(refresh=True, wide=True), mesh)
mat, lengths, n = engine.encode_kmers(kmers)
jm = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("q", None)), mat[local]
)
jl = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("q")), lengths[local]
)
c = np.asarray(
    _sharded_count_allgather64_fn(mesh, max(0, mat.shape[1] - 3))(
        dev64, jm, jl
    )
).astype(np.uint64)
counts64 = (c[0] << np.uint64(32)) | c[1]
np.testing.assert_array_equal(
    counts64[:n], np.asarray(engine.count(kmers), dtype=np.uint64)
)

j_hi = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("q")), np.zeros(32, dtype=np.uint32)
)
h_hi, h_lo = _sharded_resolve64_fn(mesh)(dev64, j_hi, jp)
full_hi = np.asarray(multihost_utils.process_allgather(h_hi, tiled=True))
full_lo = np.asarray(multihost_utils.process_allgather(h_lo, tiled=True))
wide_hits = (full_hi.astype(np.uint64) << np.uint64(32)) | full_lo.astype(
    np.uint64
)
np.testing.assert_array_equal(wide_hits, want_hits)
print(f"proc {proc_id} OK")
"""


def _run_two_process(tmp_path, worker_src):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(worker_src.replace("%PORT%", str(port)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK" in out


@pytest.mark.skipif(
    os.environ.get("AWFM_SKIP_MULTIHOST") == "1",
    reason="multi-process test disabled",
)
def test_two_process_allgather_count(tmp_path):
    _run_two_process(tmp_path, _WORKER)


@pytest.mark.skipif(
    os.environ.get("AWFM_SKIP_MULTIHOST") == "1",
    reason="multi-process test disabled",
)
def test_two_process_locate_and_wide(tmp_path):
    _run_two_process(tmp_path, _WORKER_LOCATE)
