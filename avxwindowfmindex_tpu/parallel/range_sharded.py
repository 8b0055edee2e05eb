"""Range-sharded index mode: BWT blocks partitioned across the mesh.

The replicated-index mode (dist.py) needs the whole index in every
chip's HBM. When the index exceeds per-chip HBM (SURVEY.md §5: the
reference's long-sequence story is capacity), the block array is instead
PARTITIONED by contiguous block range across a mesh axis — the block
index ``pos // 256`` is a static partition key
(AwFmIndexStruct.c:117-119).

Rank lookups then become a collective: every shard receives the full
(replicated) position batch, computes occurrences only for positions
whose block it owns (others are clamped and masked to zero), and a
``psum`` over the index axis assembles the global answer — each position
is owned by exactly one shard, so the sum IS the value. Prefix sums and
the seed table are small and stay replicated; the sampled SA is also
range-sharded.

This trades throughput for capacity: each backward step costs one
masked gather per shard (the psum is tiny — one u32 per query
side). Use the replicated engine when the index fits.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from ..models import alphabet as alpha
from ..models.index import DeviceIndex, FmIndex, POSITIONS_PER_BLOCK
from ..ops import rank as rank_ops
from ..ops import rank64 as r64
from ..search import SearchEngine, _round_up, _round_up_pow2

AXIS = "i"  # index-shard mesh axis


def make_index_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (AXIS,))


def _local_occurrence(dev, positions, letter_indices, first_block, num_local_blocks):
    """occ for positions owned by this shard; 0 elsewhere.

    dev.packed here is the LOCAL slice of the block array; positions are
    global. Ownership: first_block <= pos//256 < first_block+num_local.
    """
    blk = (positions // POSITIONS_PER_BLOCK).astype(jnp.int32)
    local_blk = blk - first_block
    owned = (local_blk >= 0) & (local_blk < num_local_blocks)
    safe_blk = jnp.clip(local_blk, 0, num_local_blocks - 1)
    rows = dev.packed[safe_blk]
    local = (positions % POSITIONS_PER_BLOCK).astype(jnp.int32)
    occ = rank_ops._count_rows(dev, rows, local, letter_indices)
    return jnp.where(owned, occ, jnp.uint32(0))


def _sharded_backward_step(dev, start, end, letter_indices, active,
                           first_block, num_local_blocks):
    """backward_step with rank assembled by psum over the index axis."""
    b = start.shape[0]
    c = rank_ops._prefix_sum_select(dev, letter_indices)
    pos = jnp.concatenate([start - jnp.uint32(1), end])
    ll = jnp.concatenate([letter_indices, letter_indices])
    occ_local = _local_occurrence(dev, pos, ll, first_block, num_local_blocks)
    occ = jax.lax.psum(occ_local, AXIS)
    new_start = c + occ[:b]
    new_end = c + occ[b:] - jnp.uint32(1)
    keep = active & (start <= end)
    return jnp.where(keep, new_start, start), jnp.where(keep, new_end, end)


def _local_rows64(dev, pos_hi, pos_lo, first_block, num_local_blocks):
    """(rows, local, owned) for this shard's slice of a wide block array.

    Global block = (pos_hi << 24) | (pos_lo >> 8) — exactly one shard
    owns each position, so per-lane psum of masked values assembles the
    global answer with no carries between shards.
    """
    blk = ((pos_hi << jnp.uint32(24)) | (pos_lo >> jnp.uint32(8))).astype(
        jnp.int32
    )
    local_blk = blk - first_block
    owned = (local_blk >= 0) & (local_blk < num_local_blocks)
    safe = jnp.clip(local_blk, 0, num_local_blocks - 1)
    local = (pos_lo & jnp.uint32(0xFF)).astype(jnp.int32)
    return dev.packed[safe], local, owned


def _sharded_backward_step64(dev, s_hi, s_lo, e_hi, e_lo, letter_indices,
                             active, first_block, num_local_blocks):
    """backward_step64 with hi/lo occurrence lanes psum-assembled."""
    b = s_lo.shape[0]
    c_hi, c_lo = r64._prefix_select64(dev, letter_indices)
    ps_hi, ps_lo = r64.sub64_small(s_hi, s_lo, jnp.uint32(1))
    pos_hi = jnp.concatenate([ps_hi, e_hi])
    pos_lo = jnp.concatenate([ps_lo, e_lo])
    ll = jnp.concatenate([letter_indices, letter_indices])
    rows, local, owned = _local_rows64(
        dev, pos_hi, pos_lo, first_block, num_local_blocks
    )
    occ_hi, occ_lo = r64._count_rows64(dev, rows, local, ll)
    # one stacked psum: collective launch latency is per-call and this
    # runs inside every scan step
    occ = jax.lax.psum(
        jnp.where(owned[None, :], jnp.stack([occ_hi, occ_lo]), jnp.uint32(0)),
        AXIS,
    )
    occ_hi, occ_lo = occ[0], occ[1]
    ns_hi, ns_lo = r64.add64(c_hi, c_lo, occ_hi[:b], occ_lo[:b])
    ne_hi, ne_lo = r64.add64(c_hi, c_lo, occ_hi[b:], occ_lo[b:])
    ne_hi, ne_lo = r64.sub64_small(ne_hi, ne_lo, jnp.uint32(1))
    keep = active & r64.le64(s_hi, s_lo, e_hi, e_lo)
    ns_hi, ns_lo = r64.where64(keep, ns_hi, ns_lo, s_hi, s_lo)
    ne_hi, ne_lo = r64.where64(keep, ne_hi, ne_lo, e_hi, e_lo)
    return ns_hi, ns_lo, ne_hi, ne_lo


class RangeShardedSearchEngine(SearchEngine):
    """count/locate with the block array range-sharded across the mesh.

    The search semantics (and results) are identical to the
    single-device engine; only the storage layout and the rank
    collective differ.
    """

    def __init__(self, index: FmIndex, mesh: Optional[Mesh] = None,
                 wide: Optional[bool] = None):
        self.host_index = index
        self.mesh = mesh if mesh is not None else make_index_mesh()
        self.n_dev = int(self.mesh.devices.size)
        if index.sampled_sa is None:
            raise ValueError(
                "range-sharded search requires the sampled suffix array in "
                "memory (load with keep_suffix_array_in_memory=True)"
            )
        # bwtLength >= 2^32 routes to the hi/lo-u32 wide layout (same
        # dual as FmIndex.to_device) — the 32-bit layout would silently
        # truncate positions/milestones/SA
        self.wide = bool(
            wide if wide is not None else int(index.bwt_length) >= 2**32
        )
        if not self.wide and int(index.bwt_length) >= 2**32:
            # an explicit wide=False override must not silently truncate
            # SA/prefix-sums/seed-table values to uint32 (same guard as
            # FmIndex.to_device)
            raise ValueError(
                "bwtLength >= 2**32 requires the 64-bit layout "
                "(wide=True, chosen automatically)"
            )
        if self.wide:
            if index.num_blocks >= 2**31:
                raise ValueError(
                    "device block index rides int32 gathers: bwtLength "
                    "must be < 2^39 positions (~550 G bases)"
                )
            ratio = int(index.config.suffix_array_compression_ratio)
            if index.bwt_length // ratio >= 2**31:
                raise ValueError(
                    "sampled-SA gather index must fit int32: need "
                    "bwtLength / saCompressionRatio < 2^31"
                )
        self._ascii_lut = (
            alpha.AA_ASCII_TO_INDEX
            if index.alphabet.name == "AMINO"
            else alpha.NT_ASCII_TO_INDEX
        )

        # Build shards HOST-side: this mode exists for indexes that do
        # not fit one card, so the block array must never round-trip
        # through a single device.
        from ..models.index import (
            device_code_masks,
            pack_device_blocks,
        )

        if self.wide:
            # compact (non-pair) wide rows: the sharded rank is a
            # two-gather step either way, and capacity is the point here
            packed_host_full = r64.pack_device_blocks64(
                index.bwt_letters, index.milestones(), index.alphabet,
                pair=False,
            )
        else:
            packed_host_full = pack_device_blocks(
                index.bwt_letters, index.milestones(), index.alphabet
            )
        nb = packed_host_full.shape[0]
        self.blocks_per_shard = -(-nb // self.n_dev)  # ceil
        nb_padded = self.blocks_per_shard * self.n_dev
        packed_host = np.zeros(
            (nb_padded, packed_host_full.shape[1]), dtype=np.uint8
        )
        packed_host[:nb] = packed_host_full
        del packed_host_full
        # sampled SA sharded the same way (by sample index range)
        n_samples = len(index.sampled_sa)
        self.samples_per_shard = -(-n_samples // self.n_dev)
        if self.wide:
            sa_hi, sa_lo = r64.split_u64_host(index.sampled_sa)
            sa_padded = np.zeros(
                (self.samples_per_shard * self.n_dev, 2), dtype=np.uint32
            )
            sa_padded[:n_samples, 0] = sa_lo
            sa_padded[:n_samples, 1] = sa_hi
        else:
            sa_padded = np.zeros(
                self.samples_per_shard * self.n_dev, dtype=np.uint32
            )
            sa_padded[:n_samples] = index.sampled_sa.astype(np.uint32)

        shard = lambda arr, spec: jax.device_put(
            jnp.asarray(arr), NamedSharding(self.mesh, spec)
        )
        rep = lambda arr: jax.device_put(
            jnp.asarray(arr), NamedSharding(self.mesh, P())
        )

        if self.wide:
            st = index.seed_table_host().astype(np.uint64)
            s_hi, s_lo = r64.split_u64_host(st[:, 0])
            e_hi, e_lo = r64.split_u64_host(st[:, 1])
            ps_hi, ps_lo = r64.split_u64_host(index.prefix_sums)
            self.dev = r64.DeviceIndex64(
                packed=shard(packed_host, P(AXIS, None)),
                prefix_hi=rep(ps_hi),
                prefix_lo=rep(ps_lo),
                seed_table=rep(np.stack([s_lo, s_hi, e_lo, e_hi], axis=1)),
                sampled_sa=shard(sa_padded, P(AXIS, None)),
                code_masks=rep(device_code_masks(index.alphabet)),
                vec_to_index=rep(
                    alpha.vector_to_index_lut(index.alphabet).astype(np.int32)
                ),
                bwt_length=int(index.bwt_length),
                ratio=int(index.config.suffix_array_compression_ratio),
                kmer_length_in_seed_table=int(
                    index.config.kmer_length_in_seed_table
                ),
                alphabet=index.alphabet,
                pair_fused=False,
            )
        else:
            self.dev = DeviceIndex(
                packed=shard(packed_host, P(AXIS, None)),
                packed_pair=None,  # capacity mode keeps the two-gather step
                prefix_sums=rep(index.prefix_sums.astype(np.uint32)),
                seed_table=rep(index.seed_table_host().astype(np.uint32)),
                sampled_sa=shard(sa_padded, P(AXIS)),
                code_masks=rep(device_code_masks(index.alphabet)),
                vec_to_index=rep(
                    alpha.vector_to_index_lut(index.alphabet).astype(np.int32)
                ),
                bwt_length=int(index.bwt_length),
                ratio=int(index.config.suffix_array_compression_ratio),
                kmer_length_in_seed_table=int(
                    index.config.kmer_length_in_seed_table
                ),
                alphabet=index.alphabet,
            )
        self._ranges_fns = {}
        self._resolve_fn = None
        self._bt_seg_fn = None

    # -- sharded kernels ----------------------------------------------------

    def _get_ranges_fn(self, seeded: bool, n_steps: int):
        key = (seeded, n_steps)
        if key in self._ranges_fns:
            return self._ranges_fns[key]
        seed_k = self.dev.kmer_length_in_seed_table
        card = self.dev.cardinality
        bps = self.blocks_per_shard

        def body64(dev, kmers, lengths):
            """Wide variant: hi/lo pointers, (A^k, 4) seed table.

            Seed/initial ranges reuse the single-device wide helpers so
            the radix/column conventions cannot drift."""
            from .. import search64

            shard_id = jax.lax.axis_index(AXIS).astype(jnp.int32)
            first_block = shard_id * bps
            if seeded:
                idxs = lengths[:, None] - seed_k + jnp.arange(
                    seed_k, dtype=jnp.int32
                )[None, :]
                last_k = jnp.take_along_axis(kmers, idxs, axis=1)
                s_hi, s_lo, e_hi, e_lo = search64._seed_lookup64(dev, last_k)
                first_pos = seed_k
            else:
                last = jnp.take_along_axis(
                    kmers, (lengths - 1)[:, None], axis=1
                )[:, 0]
                s_hi, s_lo, e_hi, e_lo = search64._initial_range64(dev, last)
                first_pos = 1

            def step(carry, t):
                sh, sl, eh, el = carry
                pos_in_kmer = lengths - first_pos - 1 - t
                active = pos_in_kmer >= 0
                lett = jnp.take_along_axis(
                    kmers, jnp.maximum(pos_in_kmer, 0)[:, None], axis=1
                )[:, 0].astype(jnp.int32)
                sh, sl, eh, el = _sharded_backward_step64(
                    dev, sh, sl, eh, el, lett, active, first_block, bps
                )
                return (sh, sl, eh, el), None

            if n_steps > 0:
                (s_hi, s_lo, e_hi, e_lo), _ = jax.lax.scan(
                    step,
                    (s_hi, s_lo, e_hi, e_lo),
                    jnp.arange(n_steps, dtype=jnp.int32),
                )
            return jnp.stack([s_hi, s_lo, e_hi, e_lo], axis=1)

        def body(dev, kmers, lengths):
            shard_id = jax.lax.axis_index(AXIS).astype(jnp.int32)
            first_block = shard_id * bps
            if seeded:
                powers = jnp.asarray(
                    [card ** (seed_k - 1 - j) for j in range(seed_k)],
                    dtype=jnp.uint32,
                )
                idxs = lengths[:, None] - seed_k + jnp.arange(
                    seed_k, dtype=jnp.int32
                )[None, :]
                last_k = jnp.take_along_axis(kmers, idxs, axis=1).astype(jnp.uint32)
                tbl = jnp.sum(last_k * powers[None, :], axis=1).astype(jnp.int32)
                seeded_ranges = dev.seed_table[tbl]
                start, end = seeded_ranges[:, 0], seeded_ranges[:, 1]
                first_pos = seed_k
            else:
                last = jnp.take_along_axis(
                    kmers, (lengths - 1)[:, None], axis=1
                )[:, 0].astype(jnp.int32)
                start = dev.prefix_sums[last]
                end = dev.prefix_sums[last + 1] - jnp.uint32(1)
                first_pos = 1

            def step(carry, t):
                s, e = carry
                pos_in_kmer = lengths - first_pos - 1 - t
                active = pos_in_kmer >= 0
                lett = jnp.take_along_axis(
                    kmers, jnp.maximum(pos_in_kmer, 0)[:, None], axis=1
                )[:, 0].astype(jnp.int32)
                s, e = _sharded_backward_step(
                    dev, s, e, lett, active, first_block, bps
                )
                return (s, e), None

            if n_steps > 0:
                (start, end), _ = jax.lax.scan(
                    step, (start, end), jnp.arange(n_steps, dtype=jnp.int32)
                )
            return jnp.stack([start, end], axis=1)

        mapped = _shard_map(
            body64 if self.wide else body, mesh=self.mesh,
            in_specs=(_dev_specs(self.dev), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
        fn = jax.jit(mapped)
        self._ranges_fns[key] = fn
        return fn

    def find_ranges_encoded(self, mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        dev = self.dev
        k = dev.kmer_length_in_seed_table
        eligible = self._seed_eligibility(mat, lengths)
        start = np.empty(mat.shape[0], dtype=np.uint64)
        end = np.empty(mat.shape[0], dtype=np.uint64)

        def run(sub_mat, sub_len, seeded: bool):
            b_pad = _round_up_pow2(sub_mat.shape[0])
            if b_pad != sub_mat.shape[0]:
                pad = b_pad - sub_mat.shape[0]
                sub_mat = np.pad(sub_mat, ((0, pad), (0, 0)))
                # max real length keeps uniform batches on the unmasked
                # fast path (mirrors SearchEngine.run)
                sub_len = np.pad(
                    sub_len, (0, pad),
                    constant_values=max(int(sub_len.max()), max(1, k)),
                )
            rep = NamedSharding(self.mesh, P())
            jm = jax.device_put(jnp.asarray(sub_mat), rep)
            jl = jax.device_put(jnp.asarray(sub_len), rep)
            n_steps = (
                max(0, sub_mat.shape[1] - k) if seeded else sub_mat.shape[1] - 1
            )
            out = self._get_ranges_fn(seeded, n_steps)(dev, jm, jl)
            if self.wide:
                o = np.asarray(out).astype(np.uint64)  # [s_hi,s_lo,e_hi,e_lo]
                return (
                    (o[:, 0] << np.uint64(32)) | o[:, 1],
                    (o[:, 2] << np.uint64(32)) | o[:, 3],
                )
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

    # -- locate: sharded backtrace ------------------------------------------

    def _get_bt_segment_fn(self):
        """Fixed-trip masked LF segment with psum-assembled ranks.

        One compiled program performs ``seg`` masked LF steps on a
        (replicated) position batch; positions already at a sample
        (p % ratio == 0) pass through unchanged. jax.jit re-specializes
        per batch shape, so the same fn serves the full batch and the
        compacted straggler batches.
        """
        if self._bt_seg_fn is not None:
            return self._bt_seg_fn
        dev_t = self.dev
        bps = self.blocks_per_shard
        ratio = dev_t.ratio
        sentinel = dev_t.sentinel
        card = dev_t.cardinality
        seg = min(64, max(4, 2 * ratio))

        def body64(dev, p_hi, p_lo, off):
            """Wide variant: hi/lo LF lanes psum-assembled per step."""
            shard_id = jax.lax.axis_index(AXIS).astype(jnp.int32)
            first_block = shard_id * bps
            u0, u1 = jnp.uint32(0), jnp.uint32(1)
            for _ in range(seg):
                done = r64.mod_small64(p_hi, p_lo, ratio) == u0
                rows, local, owned = _local_rows64(
                    dev, p_hi, p_lo, first_block, bps
                )
                # letter then occ, folded into ONE stacked psum per step
                # (collective launch latency is per-call): the letter
                # must be known before occ, but the OWNED shard computes
                # both locally — off-shard lanes contribute zero either
                # way, so lett/occ_hi/occ_lo travel together
                lett_local = rank_ops.letter_at_rows(dev, rows, local)
                lclip_local = jnp.minimum(lett_local, card)
                occ_hi, occ_lo = r64._count_rows64(
                    dev, rows, local, lclip_local
                )
                stacked = jax.lax.psum(
                    jnp.where(
                        owned[None, :],
                        jnp.stack(
                            [lett_local.astype(jnp.uint32), occ_hi, occ_lo]
                        ),
                        u0,
                    ),
                    AXIS,
                )
                lett = stacked[0].astype(jnp.int32)
                occ_hi, occ_lo = stacked[1], stacked[2]
                is_sentinel = lett == sentinel
                lclip = jnp.minimum(lett, card)
                c_hi, c_lo = r64._prefix_select64(dev, lclip)
                lf_hi, lf_lo = r64.add64(c_hi, c_lo, occ_hi, occ_lo)
                lf_hi, lf_lo = r64.sub64_small(lf_hi, lf_lo, u1)
                lf_hi = jnp.where(is_sentinel, u0, lf_hi)
                lf_lo = jnp.where(is_sentinel, u0, lf_lo)
                p_hi = jnp.where(done, p_hi, lf_hi)
                p_lo = jnp.where(done, p_lo, lf_lo)
                off = jnp.where(done, off, off + u1)
            return p_hi, p_lo, off

        def body(dev, p, off):
            shard_id = jax.lax.axis_index(AXIS).astype(jnp.int32)
            first_block = shard_id * bps
            ratio_u = jnp.uint32(ratio)
            for _ in range(seg):
                done = (p % ratio_u) == jnp.uint32(0)
                blk = (p // POSITIONS_PER_BLOCK).astype(jnp.int32)
                local_blk = blk - first_block
                owned = (local_blk >= 0) & (local_blk < bps)
                safe = jnp.clip(local_blk, 0, bps - 1)
                rows = dev.packed[safe]
                local = (p % POSITIONS_PER_BLOCK).astype(jnp.int32)
                # letter + occ in ONE stacked psum per step: the owned
                # shard's local letter IS the global letter, so its occ
                # can be computed before the collective; off-shard lanes
                # are masked to zero either way
                lett_local = rank_ops.letter_at_rows(dev, rows, local)
                occ_local = rank_ops._count_rows(
                    dev, rows, local, jnp.minimum(lett_local, card)
                )
                stacked = jax.lax.psum(
                    jnp.where(
                        owned[None, :],
                        jnp.stack([lett_local.astype(jnp.uint32), occ_local]),
                        jnp.uint32(0),
                    ),
                    AXIS,
                )
                lett = stacked[0].astype(jnp.int32)
                occ = stacked[1]
                is_sentinel = lett == sentinel
                lclip = jnp.minimum(lett, card)
                lf = rank_ops._prefix_sum_select(dev, lclip) + occ - jnp.uint32(1)
                lf = jnp.where(is_sentinel, jnp.uint32(0), lf)
                p = jnp.where(done, p, lf)
                off = jnp.where(done, off, off + jnp.uint32(1))
            return p, off

        if self.wide:
            mapped = _shard_map(
                body64, mesh=self.mesh,
                in_specs=(_dev_specs(self.dev), P(), P(), P()),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
        else:
            mapped = _shard_map(
                body, mesh=self.mesh,
                in_specs=(_dev_specs(self.dev), P(), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )
        self._bt_seg_fn = jax.jit(mapped)
        return self._bt_seg_fn

    def _get_sa_resolve_fn(self):
        """(p, off) -> database hits via the range-sharded sampled SA."""
        if self._resolve_fn is not None:
            return self._resolve_fn
        dev_t = self.dev
        sps = self.samples_per_shard
        ratio = dev_t.ratio
        bwt_length = dev_t.bwt_length

        def body64(dev, p_hi, p_lo, off):
            """Wide variant: (lo, hi) sample lanes in ONE psum, then the
            shared conditional-subtract mod (rank64.mod_bwt64)."""
            shard_id = jax.lax.axis_index(AXIS).astype(jnp.int32)
            sa_idx = r64.div_small64(p_hi, p_lo, ratio).astype(jnp.int32)
            local_idx = sa_idx - shard_id * sps
            owned = (local_idx >= 0) & (local_idx < sps)
            safe = jnp.clip(local_idx, 0, sps - 1)
            vals = dev.sampled_sa[safe]  # (B, 2) [lo, hi]
            sa = jax.lax.psum(
                jnp.where(owned[:, None], vals, jnp.uint32(0)), AXIS
            )
            h_hi, h_lo = r64.add64_small(sa[:, 1], sa[:, 0], off)
            return r64.mod_bwt64(h_hi, h_lo, bwt_length)

        def body(dev, p, off):
            shard_id = jax.lax.axis_index(AXIS).astype(jnp.int32)
            sa_idx = (p // jnp.uint32(ratio)).astype(jnp.int32)
            local_idx = sa_idx - shard_id * sps
            owned = (local_idx >= 0) & (local_idx < sps)
            safe = jnp.clip(local_idx, 0, sps - 1)
            vals = jnp.where(owned, dev.sampled_sa[safe], jnp.uint32(0))
            sa_vals = jax.lax.psum(vals, AXIS)
            # wrap-aware conditional subtract: sa + off can exceed 2^32
            # when bwtLength > 2^31 (see search._resolve_samples)
            n = jnp.uint32(bwt_length)
            h = sa_vals + off
            over = (h < sa_vals) | (h >= n)
            return jnp.where(over, h - n, h)

        if self.wide:
            mapped = _shard_map(
                body64, mesh=self.mesh,
                in_specs=(_dev_specs(self.dev), P(), P(), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )
        else:
            mapped = _shard_map(
                body, mesh=self.mesh,
                in_specs=(_dev_specs(self.dev), P(), P()),
                out_specs=P(),
                check_vma=False,
            )
        self._resolve_fn = jax.jit(mapped)
        return self._resolve_fn

    def resolve_positions(self, bwt_positions: np.ndarray) -> np.ndarray:
        """LF-backtrace + sampled-SA resolve with every rank a collective.

        Schedule: host-driven compaction local to this engine — one
        fixed-trip masked segment over the full batch, then
        geometrically smaller compacted straggler batches, with one
        small undone-count readback per level. (search.backtrace_all
        and search64.backtrace_all64 are both fully sync-free nested
        compaction; this capacity mode keeps the simpler synced loop
        because every segment is a psum collective and the mode is not
        a locate-throughput path.) Compaction is safe here because the
        POSITION batch is replicated (P()) across the mesh; only the
        block/SA tables are sharded, and each rank lookup resolves
        ownership from the position value itself. This caps the collective cost at
        ~2*ratio full-batch psum steps plus a few segments over shrunken
        batches, instead of the ~ratio*ln(B) full-batch while_loop
        iterations of the naive formulation. This mode still exists for
        indexes too big for one chip's HBM; route locate-heavy workloads
        to the replicated engine whenever the index fits
        (parallel/dist.py).
        """
        n = len(bwt_positions)
        if n == 0:
            return np.empty(0, dtype=np.uint64)
        dev = self.dev
        ratio = dev.ratio
        rep = NamedSharding(self.mesh, P())
        b_pad = _round_up_pow2(n)
        if self.wide:
            return self._resolve_positions64(bwt_positions, n, b_pad, rep)

        padded = np.zeros(b_pad, dtype=np.uint32)
        padded[:n] = bwt_positions.astype(np.uint32)
        p = jax.device_put(jnp.asarray(padded), rep)
        off = jax.device_put(jnp.zeros(b_pad, dtype=jnp.uint32), rep)

        seg_fn = self._get_bt_segment_fn()
        p, off = seg_fn(dev, p, off)
        while True:
            undone = jnp.asarray(p) % jnp.uint32(ratio) != jnp.uint32(0)
            cnt = int(np.asarray(jnp.sum(undone, dtype=jnp.int32)))
            if cnt == 0:
                break
            m = _round_up_pow2(cnt, floor=256)
            if m >= b_pad:
                p, off = seg_fn(dev, p, off)
                continue
            idx, sub_p, sub_off = _gather_undone_rs(p, off, ratio=ratio, m=m)
            sub_p, sub_off = seg_fn(dev, sub_p, sub_off)
            p = p.at[idx].set(sub_p, mode="drop")
            off = off.at[idx].set(sub_off, mode="drop")
        hits = self._get_sa_resolve_fn()(dev, p, off)
        return np.asarray(hits[:n], dtype=np.uint64)

    def _resolve_positions64(self, bwt_positions, n, b_pad, rep):
        """Wide resolve: the same compaction schedule on hi/lo lanes.

        Per-level host traffic is ONE scalar (the undone count); the
        straggler indices are compacted on device and scattered back on
        device, instead of pulling the full undone vector to the host
        at every level. The helpers below take ratio as a static
        instead of the sharded dev pytree: mixing the Auto-sharded dev
        leaves with shard_map (Manual) outputs in one jit is rejected.
        """
        dev = self.dev
        ratio = dev.ratio
        pos = np.zeros(b_pad, dtype=np.uint64)
        pos[:n] = bwt_positions.astype(np.uint64)
        hi_np, lo_np = r64.split_u64_host(pos)
        p_hi = jax.device_put(jnp.asarray(hi_np), rep)
        p_lo = jax.device_put(jnp.asarray(lo_np), rep)
        off = jax.device_put(jnp.zeros(b_pad, dtype=jnp.uint32), rep)

        seg_fn = self._get_bt_segment_fn()
        p_hi, p_lo, off = seg_fn(dev, p_hi, p_lo, off)
        while True:
            cnt = int(np.asarray(_undone_count64_rs(p_hi, p_lo, ratio=ratio)))
            if cnt == 0:
                break
            m = _round_up_pow2(cnt, floor=256)
            if m >= b_pad:
                p_hi, p_lo, off = seg_fn(dev, p_hi, p_lo, off)
                continue
            idx, s_hi, s_lo, s_off = _gather_undone64_rs(
                p_hi, p_lo, off, ratio=ratio, m=m
            )
            s_hi, s_lo, s_off = seg_fn(dev, s_hi, s_lo, s_off)
            p_hi, p_lo, off = _scatter_back64_rs(
                p_hi, p_lo, off, idx, s_hi, s_lo, s_off
            )
        h_hi, h_lo = self._get_sa_resolve_fn()(dev, p_hi, p_lo, off)
        return (
            np.asarray(h_hi[:n]).astype(np.uint64) << np.uint64(32)
        ) | np.asarray(h_lo[:n]).astype(np.uint64)


@functools.partial(jax.jit, static_argnames=("ratio", "m"))
def _gather_undone_rs(p, off, *, ratio, m):
    # pad slots: dropped done-sentinels (p=0 is done since 0 % ratio == 0),
    # same contract as the wide _gather_undone64_rs below and
    # search._gather_undone — never row-0 duplicates, which would become
    # undone-dup cap bombs if this path's segment fn ever routes slabs.
    b = p.shape[0]
    idx = jnp.nonzero(
        p % jnp.uint32(ratio) != jnp.uint32(0), size=m, fill_value=b
    )[0].astype(jnp.int32)
    pad = idx >= jnp.int32(b)
    safe = jnp.where(pad, jnp.int32(0), idx)
    z = jnp.uint32(0)
    return idx, jnp.where(pad, z, p[safe]), jnp.where(pad, z, off[safe])


@functools.partial(jax.jit, static_argnames=("ratio",))
def _undone_count64_rs(p_hi, p_lo, *, ratio):
    return jnp.sum(
        r64.mod_small64(p_hi, p_lo, ratio) != jnp.uint32(0), dtype=jnp.int32
    )


@functools.partial(jax.jit, static_argnames=("ratio", "m"))
def _gather_undone64_rs(p_hi, p_lo, off, *, ratio, m):
    # pad slots: dropped done-sentinels, same contract as
    # search64._gather_undone64 (never row-0 duplicates)
    b = p_lo.shape[0]
    idx = jnp.nonzero(
        r64.mod_small64(p_hi, p_lo, ratio) != jnp.uint32(0),
        size=m, fill_value=b,
    )[0].astype(jnp.int32)
    pad = idx >= jnp.int32(b)
    safe = jnp.where(pad, jnp.int32(0), idx)
    z = jnp.uint32(0)
    return (
        idx,
        jnp.where(pad, z, p_hi[safe]),
        jnp.where(pad, z, p_lo[safe]),
        jnp.where(pad, z, off[safe]),
    )


@jax.jit
def _scatter_back64_rs(p_hi, p_lo, off, idx, s_hi, s_lo, s_off):
    return (
        p_hi.at[idx].set(s_hi, mode="drop"),
        p_lo.at[idx].set(s_lo, mode="drop"),
        off.at[idx].set(s_off, mode="drop"),
    )


def _dev_specs(dev):
    """PartitionSpec pytree matching the range-sharded device index.

    Built by unflattening into the actual dev's treedef so the static
    metadata matches exactly. Leaf order follows the registered data
    fields — DeviceIndex: packed, prefix_sums, seed_table, sampled_sa,
    code_masks, vec_to_index; DeviceIndex64: packed, prefix_hi,
    prefix_lo, seed_table, sampled_sa (2-D), code_masks, vec_to_index.
    """
    _, treedef = jax.tree.flatten(dev)
    if isinstance(dev, DeviceIndex):
        specs = [P(AXIS, None), P(), P(), P(AXIS), P(), P()]
    else:
        specs = [P(AXIS, None), P(), P(), P(), P(AXIS, None), P(), P()]
    return jax.tree.unflatten(treedef, specs)
