"""Scaling report: queries/s across mesh sizes and host counts.

BASELINE.md's scaling deliverable asks for queries/s at 1 chip, 1 host,
and N>=2 hosts with a replicated index and an all-gather hit merge. The
reference has no distributed mode at all (its scaling story is an OpenMP
thread pool, AwFmParallelSearch.c:103); this tool measures the
device replacement (parallel/dist.py) at each rung:

  - single device                      (1 chip)
  - 1-D "q" mesh of 2/4/8 devices      (1 host, data-parallel queries)
  - N jax.distributed processes        (N "hosts", global mesh,
                                        all_gather count merge)

With ``--platform cpu`` (the default) the same program runs on a
virtual CPU mesh, which validates the sharding/collective structure and
measures *scaling shape* — per-device work should stay constant in weak
scaling and drop ~linearly in strong scaling — not device throughput.
On a multi-GPU host run ``--platform gpu``: the mesh rungs then use the
cards and the collectives ride NVLink. The multi-process rung's workers
always stay on virtual CPU devices, so no second process opens a card.

Usage:
    python -m avxwindowfmindex_tpu.tools.scaling_report \
        [--bases 1048576] [--queries 8192] [--kmer-len 25] [--seed-k 8] \
        [--devices 1,2,4,8] [--mode strong|weak] [--hosts 2] \
        [--platform cpu|gpu] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bases", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=8192,
                    help="total queries (strong) / per-device (weak)")
    ap.add_argument("--kmer-len", type=int, default=25)
    ap.add_argument("--seed-k", type=int, default=8)
    ap.add_argument("--sa-ratio", type=int, default=8)
    ap.add_argument("--devices", type=str, default="1,2,4,8",
                    help="comma-separated mesh sizes")
    ap.add_argument("--mode", choices=["strong", "weak"], default="strong")
    ap.add_argument("--hosts", type=int, default=2,
                    help="process count for the multi-host rung (0 = skip)")
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _force_platform(platform: str, n_virtual: int) -> None:
    """Must run before backend init: device count is an XLA flag.

    ``jax.config.update`` wins over an earlier import of jax, because
    backends initialize lazily (same pattern as tests/conftest.py). The
    gpu platform is required, not forced: without a GPU it raises.
    """
    if platform == "gpu":
        import jax

        got = jax.devices()[0].platform
        if got != "gpu":
            raise RuntimeError(f"--platform gpu, but JAX found {got}")
        return
    if platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n_virtual}"
            ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")


def _build(args):
    import numpy as np
    from avxwindowfmindex_tpu import (
        AlphabetType, IndexConfiguration, create_index,
    )

    rng = np.random.default_rng(args.seed)
    seq = rng.choice(
        np.frombuffer(b"ACGT", np.uint8), size=args.bases
    ).tobytes()
    cfg = IndexConfiguration(
        args.sa_ratio, args.seed_k, AlphabetType.DNA,
        keep_suffix_array_in_memory=True,
    )
    index = create_index(seq, cfg)
    return seq, index, rng


def _make_queries(rng, seq: bytes, n: int, k: int):
    import numpy as np

    pos = rng.integers(0, len(seq) - k, size=n)
    return [seq[p : p + k] for p in pos]


def _timed(fn, repeats: int):
    import numpy as np

    fn()  # warmup / compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        np.asarray(out)  # force completion
        best = min(best, time.perf_counter() - t0)
    return best


def _single_host_rows(args, index, rng, seq):
    import jax
    import numpy as np
    from avxwindowfmindex_tpu.parallel.dist import (
        DistributedSearchEngine, make_query_mesh,
    )

    sizes = [int(s) for s in args.devices.split(",")]
    avail = len(jax.devices())
    rows = []
    for n_dev in sizes:
        if n_dev > avail:
            print(f"[scaling] skip mesh={n_dev}: only {avail} devices")
            continue
        n_q = args.queries * (n_dev if args.mode == "weak" else 1)
        kmers = _make_queries(rng, seq, n_q, args.kmer_len)
        eng = DistributedSearchEngine(index, make_query_mesh(n_dev))
        t_count = _timed(lambda: eng.count(kmers), args.repeats)
        t_rep = _timed(lambda: eng.count_replicated(kmers), args.repeats)
        t_locate = _timed(
            lambda: np.concatenate(
                [np.asarray(h) for h in eng.locate(kmers)] or [np.empty(0)]
            ),
            args.repeats,
        )
        rows.append({
            "rung": f"1 host x {n_dev} dev",
            "devices": n_dev, "hosts": 1, "queries": n_q,
            "count_qps": n_q / t_count,
            "count_allgather_qps": n_q / t_rep,
            "locate_qps": n_q / t_locate,
        })
        print(f"[scaling] mesh={n_dev}: count {rows[-1]['count_qps']:.0f} q/s, "
              f"all-gather {rows[-1]['count_allgather_qps']:.0f} q/s, "
              f"locate {rows[-1]['locate_qps']:.0f} q/s")
    return rows


_HOST_WORKER = r"""
import os, sys, time, json
proc_id, n_procs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfgj = json.loads(sys.argv[4])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:" + port,
    num_processes=n_procs, process_id=proc_id,
)
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from avxwindowfmindex_tpu import AlphabetType, IndexConfiguration, create_index
from avxwindowfmindex_tpu.parallel.dist import (
    _sharded_count_allgather_fn, replicate_index,
)
from avxwindowfmindex_tpu.search import SearchEngine

rng = np.random.default_rng(cfgj["seed"])
seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=cfgj["bases"]).tobytes()
index = create_index(
    seq, IndexConfiguration(cfgj["sa_ratio"], cfgj["seed_k"], AlphabetType.DNA)
)
mesh = Mesh(np.array(jax.devices()), ("q",))
dev = replicate_index(index.to_device(), mesh)
engine = SearchEngine(index)
k = cfgj["kmer_len"]
pos = rng.integers(0, len(seq) - k, size=cfgj["queries"])
kmers = [seq[p : p + k] for p in pos]
mat, lengths, n = engine.encode_kmers(kmers)
gb = mat.shape[0]
local = slice(proc_id * gb // n_procs, (proc_id + 1) * gb // n_procs)
jm = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("q", None)), mat[local])
jl = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("q")), lengths[local])
fn = _sharded_count_allgather_fn(mesh, max(0, mat.shape[1] - cfgj["seed_k"]))
np.asarray(jax.device_get(fn(dev, jm, jl)))  # warmup
best = float("inf")
for _ in range(cfgj["repeats"]):
    t0 = time.perf_counter()
    out = fn(dev, jm, jl)
    np.asarray(jax.device_get(out))
    best = min(best, time.perf_counter() - t0)
print("RESULT " + json.dumps({"proc": proc_id, "seconds": best, "queries": n}))
"""


def _multihost_row(args, tmpdir: str):
    """N-process rung: global mesh, all_gather count merge."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = os.path.join(tmpdir, "scaling_worker.py")
    with open(script, "w") as f:
        f.write(_HOST_WORKER)
    cfgj = json.dumps({
        "bases": args.bases, "queries": args.queries,
        "kmer_len": args.kmer_len, "seed_k": args.seed_k,
        "sa_ratio": args.sa_ratio, "repeats": args.repeats,
        "seed": args.seed,
    })
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers pin their own device count
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(i), str(args.hosts), port, cfgj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(args.hosts)
    ]
    try:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    except subprocess.TimeoutExpired:
        # a hung worker must not take down the already-measured
        # single-host rows (or leave orphan processes); kill the exact
        # PIDs we spawned and skip this rung
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
        print("[scaling] multihost rung timed out (worker hung); skipping")
        return None
    secs, n_q = None, None
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"[scaling] host proc {i} failed:\n{out}")
            return None
        for line in out.splitlines():
            if line.startswith("RESULT ") and i == 0:
                rec = json.loads(line[len("RESULT "):])
                secs, n_q = rec["seconds"], rec["queries"]
    if secs is None:
        return None
    row = {
        "rung": f"{args.hosts} hosts x 4 dev (all-gather merge)",
        "devices": 4 * args.hosts, "hosts": args.hosts, "queries": n_q,
        "count_allgather_qps": n_q / secs,
    }
    print(f"[scaling] {row['rung']}: {row['count_allgather_qps']:.0f} q/s")
    return row


def main(argv=None) -> int:
    args = _parse_args(argv)
    try:
        sizes = [int(s) for s in args.devices.split(",")]
        if not sizes or any(s < 1 for s in sizes):
            raise ValueError(sizes)
    except ValueError:
        print(f"error: --devices must be a comma-separated list of "
              f"positive mesh sizes, got {args.devices!r}", file=sys.stderr)
        return 2
    max_dev = max(sizes)
    _force_platform(args.platform, max_dev)

    import tempfile

    print(f"[scaling] platform={args.platform} bases={args.bases} "
          f"queries={args.queries} k={args.kmer_len} mode={args.mode}")
    seq, index, rng = _build(args)
    rows = _single_host_rows(args, index, rng, seq)
    if args.hosts >= 2:
        with tempfile.TemporaryDirectory() as td:
            row = _multihost_row(args, td)
        if row is not None:
            rows.append(row)

    hdr = ("| rung | devices | queries | count q/s | all-gather count q/s "
           "| locate q/s |")
    print()
    print(hdr)
    print("|" + "---|" * 6)
    for r in rows:
        print("| {} | {} | {} | {} | {:.0f} | {} |".format(
            r["rung"], r["devices"], r["queries"],
            ("%.0f" % r["count_qps"]) if "count_qps" in r else "-",
            r["count_allgather_qps"],
            ("%.0f" % r["locate_qps"]) if "locate_qps" in r else "-",
        ))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args), "rows": rows}, f, indent=2)
        print(f"[scaling] wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
