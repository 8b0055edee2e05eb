"""Multi-device distribution: shard_map data parallelism over the query axis.

The reference's entire scaling story is an OpenMP thread pool on one
node (AwFmParallelSearch.c:103). The device design (SURVEY.md §2.2):

  - the index (letters/milestones/prefix-sums/seed-table/sampled-SA) is
    REPLICATED across the mesh (it is read-only during search);
  - the query batch is SHARDED over a 1-D "q" mesh axis;
  - count/range search needs no communication at all;
  - hit merging uses an ``all_gather`` over the device interconnect
    (NVLink between the cards of one host) when a replicated result
    is wanted (the north-star collective), otherwise results stay
    sharded and stream back per-host.

Multi-host: the same code runs under ``jax.distributed`` — each host
feeds its process-local query shard via
``jax.make_array_from_process_local_data`` and the mesh spans all hosts.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map as _shard_map  # jax >= 0.6
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from ..models.index import DeviceIndex, FmIndex
from ..search import (
    SearchEngine,
    _backtrace_resolve,
    _ranges_steploop,
    _round_up,
    _round_up_pow2,
    _seeded_ranges,
    _unseeded_ranges,
    _use_step_loop,
)


def make_query_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over the query-parallel axis "q"."""
    devs = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), ("q",))


def replicate_index(dev: DeviceIndex, mesh: Mesh) -> DeviceIndex:
    """Place every index array replicated across the mesh."""
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, rep), dev)


@functools.lru_cache(maxsize=64)
def _sharded_ranges_fn(mesh: Mesh, seeded: bool, n_steps: int):
    """Build + cache the jitted shard_map for a (mesh, shape) combo."""

    if seeded:
        def body(dev, kmers, lengths):
            s, e = _seeded_ranges(dev, kmers, lengths, n_ext=n_steps)
            return jnp.stack([s, e], axis=1)
    else:
        def body(dev, kmers, lengths):
            s, e = _unseeded_ranges(dev, kmers, lengths, n_steps=n_steps)
            return jnp.stack([s, e], axis=1)

    mapped = _shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("q", None), P("q")),
        out_specs=P("q"),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _sharded_resolve_fn(mesh: Mesh):
    mapped = _shard_map(
        _backtrace_resolve, mesh=mesh,
        in_specs=(P(), P("q")),
        out_specs=P("q"),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _sharded_backtrace_fn(mesh: Mesh):
    """Query-sharded LF backtrace WITHOUT the SA resolve — the on-disk
    suffix-array mode: the walk to a sampled position stays on the mesh
    and only the final packed-SA file reads run on host
    (awFmGetSuffixArrayValueFromFile is the reference's disk-residency
    contract, AwFmFile.c:484-522)."""
    from ..search import _backtrace_to_sampled

    mapped = _shard_map(
        _backtrace_to_sampled, mesh=mesh,
        in_specs=(P(), P("q")),
        out_specs=(P("q"), P("q")),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _sharded_resolve64_fn(mesh: Mesh):
    """Wide (hi/lo-u32) backtrace+resolve, query-sharded."""
    from ..search64 import _backtrace_resolve64

    mapped = _shard_map(
        _backtrace_resolve64, mesh=mesh,
        in_specs=(P(), P("q"), P("q")),
        out_specs=(P("q"), P("q")),
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _sharded_count_allgather_fn(mesh: Mesh, n_steps: int):
    """Count with an all_gather hit merge: every device ends with the
    full counts vector (the BASELINE.json north-star collective)."""

    def body(dev, kmers, lengths):
        s, e = _seeded_ranges(dev, kmers, lengths, n_ext=n_steps)
        counts = jnp.where(s <= e, e - s + jnp.uint32(1), jnp.uint32(0))
        return jax.lax.all_gather(counts, "q", tiled=True)

    # check_vma=False: the all_gather output IS replicated over "q", but
    # the static varying-mesh-axes check cannot infer that.
    mapped = _shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("q", None), P("q")),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _sharded_count_allgather64_fn(mesh: Mesh, n_steps: int):
    """Wide (hi/lo-u32) count merge, scan formulation (CPU backends):
    range widths can exceed uint32, so hi and lo count lanes travel as
    one stacked all_gather and are joined on host."""
    from .. import search64
    from ..ops import rank64 as r64

    def body(dev, kmers, lengths):
        s_hi, s_lo, e_hi, e_lo = search64._ranges_scan64(
            dev, kmers, lengths, n_steps=n_steps, seeded=True
        )
        valid = r64.le64(s_hi, s_lo, e_hi, e_lo)
        c_hi, c_lo = r64.add64_small(
            *r64.sub64(e_hi, e_lo, s_hi, s_lo), jnp.uint32(1)
        )
        c = jnp.where(
            valid[None, :], jnp.stack([c_hi, c_lo]), jnp.uint32(0)
        )
        return jax.lax.all_gather(c, "q", axis=1, tiled=True)

    mapped = _shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("q", None), P("q")),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _gather_counts64_fn(mesh: Mesh):
    """all_gather the hi/lo count lanes of already-sharded wide ranges
    (the step-loop path's merge: one stacked collective)."""
    from ..ops import rank64 as r64

    def body(s_hi, s_lo, e_hi, e_lo):
        valid = r64.le64(s_hi, s_lo, e_hi, e_lo)
        c_hi, c_lo = r64.add64_small(
            *r64.sub64(e_hi, e_lo, s_hi, s_lo), jnp.uint32(1)
        )
        c = jnp.where(
            valid[None, :], jnp.stack([c_hi, c_lo]), jnp.uint32(0)
        )
        return jax.lax.all_gather(c, "q", axis=1, tiled=True)

    mapped = _shard_map(
        body, mesh=mesh,
        in_specs=(P("q"), P("q"), P("q"), P("q")),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(mapped)


class DistributedSearchEngine(SearchEngine):
    """Query-data-parallel search over a device mesh.

    Same API as :class:`SearchEngine`; batches are padded to a multiple
    of the mesh size and sharded over the "q" axis; the index is
    replicated once at construction.
    """

    def __init__(self, index: Union[FmIndex, DeviceIndex], mesh: Optional[Mesh] = None):
        super().__init__(index)
        self.mesh = mesh if mesh is not None else make_query_mesh()
        self.n_dev = self.mesh.devices.size
        # DeviceIndex and DeviceIndex64 (wide, bwtLength >= 2^32) are
        # both registered pytrees; wide batches route through
        # search64.ranges64 with this engine's sharding hook below.
        self.dev = replicate_index(self.dev, self.mesh)

    # batch padding must be divisible by the mesh
    def _pad_batch(self, n: int) -> int:
        return _round_up(_round_up_pow2(n), self.n_dev)

    def _shard(self, arr: np.ndarray):
        spec = P("q") if arr.ndim == 1 else P("q", *([None] * (arr.ndim - 1)))
        return jax.device_put(jnp.asarray(arr), NamedSharding(self.mesh, spec))

    def find_ranges_encoded(self, mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        dev = self.dev
        k = dev.kmer_length_in_seed_table
        eligible = self._seed_eligibility(mat, lengths)
        start = np.empty(mat.shape[0], dtype=np.uint64)
        end = np.empty(mat.shape[0], dtype=np.uint64)

        def run(sub_mat, sub_len, seeded: bool):
            b_pad = self._pad_batch(sub_mat.shape[0])
            if b_pad != sub_mat.shape[0]:
                pad = b_pad - sub_mat.shape[0]
                sub_mat = np.pad(sub_mat, ((0, pad), (0, 0)))
                # max real length keeps uniform batches on the unmasked
                # fast path (mirrors SearchEngine.run)
                sub_len = np.pad(
                    sub_len, (0, pad),
                    constant_values=max(int(sub_len.max()), max(1, k)),
                )
            if self.wide:
                from .. import search64

                # hi/lo-u32 programs are GSPMD-partitionable the same
                # way (batch elementwise + replicated-table gathers);
                # the pair-window fixup sub-batch keeps mesh
                # divisibility via pad_multiple
                r = search64.ranges64(
                    dev, sub_mat, sub_len, seeded,
                    put=self._shard, pad_multiple=self.n_dev,
                )
                return r[:, 0], r[:, 1]
            if _use_step_loop():
                # per-step GSPMD-partitioned programs: batch elementwise
                # + replicated-table gathers, no collectives, and no
                # monolithic scan program to compile on pod runtimes.
                # The pair-window flag count folds into the ONE result
                # readback (defer protocol, as in SearchEngine).
                pend = []
                s, e = _ranges_steploop(
                    dev, sub_mat, sub_len, seeded, put=self._shard,
                    defer=pend, pad_multiple=self.n_dev,
                )
                flat = np.asarray(
                    jnp.concatenate(
                        [c[None].astype(jnp.uint32) for c, _ in pend]
                        + [s, e]
                    )
                )
                nf = len(pend)
                if nf and flat[:nf].any():
                    s, e = pend[0][1]()  # rare: exact re-run of flagged
                    return (
                        np.asarray(s, dtype=np.uint64),
                        np.asarray(e, dtype=np.uint64),
                    )
                b = s.shape[0]
                return (
                    flat[nf : nf + b].astype(np.uint64),
                    flat[nf + b :].astype(np.uint64),
                )
            jm = self._shard(sub_mat)
            jl = self._shard(sub_len)
            if seeded:
                fn = _sharded_ranges_fn(
                    self.mesh, True, max(0, sub_mat.shape[1] - k)
                )
            else:
                fn = _sharded_ranges_fn(self.mesh, False, sub_mat.shape[1] - 1)
            out = fn(dev, jm, jl)
            out = np.asarray(out, dtype=np.uint64)
            return out[:, 0], out[:, 1]

        if eligible.all():
            start, end = run(mat, lengths, True)
        elif not eligible.any():
            start, end = run(mat, lengths, False)
        else:
            idx_e = np.where(eligible)[0]
            idx_u = np.where(~eligible)[0]
            s, e = run(mat[idx_e], lengths[idx_e], True)
            start[idx_e], end[idx_e] = s[: len(idx_e)], e[: len(idx_e)]
            s, e = run(mat[idx_u], lengths[idx_u], False)
            start[idx_u], end[idx_u] = s[: len(idx_u)], e[: len(idx_u)]
        return np.stack([start[: mat.shape[0]], end[: mat.shape[0]]], axis=1)

    def resolve_positions(self, bwt_positions: np.ndarray) -> np.ndarray:
        dev = self.dev
        n = len(bwt_positions)
        if n == 0:
            return np.empty(0, dtype=np.uint64)
        if dev.sampled_sa is None:
            if self.wide:
                # wide on-disk resolve stays host-routed (hi/lo file math)
                return super().resolve_positions(bwt_positions)
            # on-disk SA: keep the backtrace mesh-sharded; only the
            # final <=9-byte packed-SA reads run on host (the locate
            # tail never serializes through a single device)
            if self.host_index is None or self.host_index.file_path is None:
                raise ValueError(
                    "suffix array not in memory and no backing file to "
                    "read from (build or load the index with a file_src)"
                )
            b_pad = self._pad_batch(n)
            padded = np.zeros(b_pad, dtype=np.uint32)
            padded[:n] = bwt_positions.astype(np.uint32)
            p, off = _sharded_backtrace_fn(self.mesh)(
                dev, self._shard(padded)
            )
            return self._resolve_from_file(
                np.asarray(p[:n]), np.asarray(off[:n])
            )
        b_pad = self._pad_batch(n)
        if self.wide:
            padded = np.zeros(b_pad, dtype=np.uint64)
            padded[:n] = bwt_positions.astype(np.uint64)
            hi = (padded >> np.uint64(32)).astype(np.uint32)
            lo = (padded & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            h_hi, h_lo = _sharded_resolve64_fn(self.mesh)(
                dev, self._shard(hi), self._shard(lo)
            )
            return (
                np.asarray(h_hi[:n]).astype(np.uint64) << np.uint64(32)
            ) | np.asarray(h_lo[:n]).astype(np.uint64)
        padded = np.zeros(b_pad, dtype=np.uint32)
        padded[:n] = bwt_positions.astype(np.uint32)
        fn = _sharded_resolve_fn(self.mesh)
        hits = fn(dev, self._shard(padded))
        return np.asarray(hits[:n], dtype=np.uint64)

    def count_replicated(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """Counts merged to every device with all_gather."""
        dev = self.dev
        mat, lengths, n = self.encode_kmers(kmers)
        if not self._seed_eligibility(mat, lengths).all():
            raise ValueError("count_replicated requires seed-eligible kmers")
        b_pad = self._pad_batch(mat.shape[0])
        if b_pad != mat.shape[0]:
            mat = np.pad(mat, ((0, b_pad - mat.shape[0]), (0, 0)))
            lengths = np.pad(
                lengths, (0, b_pad - len(lengths)),
                constant_values=dev.kmer_length_in_seed_table,
            )
        n_steps = max(0, mat.shape[1] - dev.kmer_length_in_seed_table)
        if self.wide:
            from .. import search64

            if _use_step_loop():
                # per-step GSPMD programs instead of a monolithic scan
                # (the step loop, as in SearchEngine); flag count + both
                # count lanes fold into ONE readback
                pair = dev.pair_fused and search64._use_pair_rows64()
                s_hi, s_lo, e_hi, e_lo, bad = search64._ranges_steploop64(
                    dev, mat, lengths, True, pair, put=self._shard
                )
                c = _gather_counts64_fn(self.mesh)(s_hi, s_lo, e_hi, e_lo)
                flag = (
                    search64._flag_count64(bad).astype(jnp.uint32)[None]
                    if bad is not None
                    else jnp.zeros(1, dtype=jnp.uint32)
                )
                flat = np.asarray(jnp.concatenate([flag, c[0], c[1]]))
                b = mat.shape[0]
                if flat[0]:
                    # rare: a range outgrew the pair window — exact
                    # two-gather re-run, counts derived on host
                    r = search64.ranges64_exact(
                        dev, mat, lengths, True, put=self._shard
                    )
                    s_, e_ = r[:, 0], r[:, 1]
                    counts = np.where(s_ <= e_, e_ - s_ + 1, 0)
                    return counts.astype(np.uint64)[:n]
                c_hi = flat[1 : 1 + b].astype(np.uint64)
                c_lo = flat[1 + b :].astype(np.uint64)
                return ((c_hi << np.uint64(32)) | c_lo)[:n]
            c = np.asarray(
                _sharded_count_allgather64_fn(self.mesh, n_steps)(
                    dev, self._shard(mat), self._shard(lengths)
                )
            ).astype(np.uint64)
            return ((c[0] << np.uint64(32)) | c[1])[:n]
        fn = _sharded_count_allgather_fn(self.mesh, n_steps)
        counts = fn(dev, self._shard(mat), self._shard(lengths))
        return np.asarray(counts[:n], dtype=np.uint64)
