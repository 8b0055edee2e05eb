"""Vectorized k-mer seed-table construction.

The reference fills all |A|^k memoized ranges with a depth-first
recursion, one backward step per tree edge (AwFmCreate.c:407-450). The
device build performs the identical recurrence breadth-first and batched:
at depth d it holds the |A|^d ranges of all d-length suffixes and
extends every one of them by every letter in a single batched backward
step, producing |A|^(d+1) ranges with the index arithmetic

    new_index = letter * |A|^d + old_index

which matches the reference's ``currentKmerIndex + letter * multiplier``
(AwFmCreate.c:444-445); the final leaf values are bit-identical,
including the not-canonical (startPtr > endPtr) values stored for absent
kmers, because the builder — like the reference DFS — steps ranges
unconditionally, without a validity check.

Engineering choices:
  - all ranges stay DEVICE-RESIDENT between depths (no host round trip
    per depth);
  - each depth is one (or a few) dispatches of a SIMPLE program: small
    per-depth gather+elementwise programs compile quickly and hit the
    persistent compilation cache on later builds, where one fused
    monolith (fori_loop + lax.map) compiled slowly.
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

_DEBUG_TIMING = bool(os.environ.get("AWFM_DEBUG_TIMING"))

from . import rank as rank_ops

# Ranges stepped per dispatch at the deepest levels; bounds the gather
# temporaries (each range costs two fused-row reads plus ~6x that in
# elementwise temporaries; 2^21 ranges keep a dispatch under ~2 GB —
# oversubscribing HBM sends XLA into a pathological spill regime
# measured at 100x slowdown).
_CHUNK = 1 << 21


@jax.jit
def _extend_all_letters(dev, start, end):
    """Step each of N ranges by every letter: returns (card*N,) arrays
    ordered letter-major (new_index = letter * N + old_index)."""
    card = dev.cardinality
    n = start.shape[0]
    start_t = jnp.tile(start, card)
    end_t = jnp.tile(end, card)
    letts = jnp.repeat(jnp.arange(card, dtype=jnp.int32), n)
    return rank_ops.backward_step(
        dev, start_t, end_t, letts, active=None, check_valid=False
    )


@jax.jit
def _extend_chunk(dev, start, end, lett_value):
    """Step a chunk of ranges by one letter (deep levels)."""
    letts = jnp.full(start.shape, lett_value, dtype=jnp.int32)
    return rank_ops.backward_step(
        dev, start, end, letts, active=None, check_valid=False
    )


def build_seed_table_device(dev, cardinality: int, k: int, prefix_sums_host=None):
    """Compute the (|A|^k, 2) uint32 seed table, kept ON DEVICE.

    Depth-1 ranges come straight from the prefix sums
    (AwFmCreate.c:410-413): table1[i] = [C[i], C[i+1]-1]. Host
    materialization for serde is lazy (FmIndex.seed_table_host).

    Pass ``prefix_sums_host`` when available: it saves a device->host
    readback.
    """
    total = cardinality**k
    if total >= 2**31:
        raise NotImplementedError(
            f"seed table with |A|^k = {total} exceeds the int32 device "
            "index range; use a smaller kmerLengthInSeedTable"
        )
    if prefix_sums_host is not None:
        ps = np.asarray(prefix_sums_host, dtype=np.uint64)
    else:
        ps = np.asarray(dev.prefix_sums, dtype=np.uint64)
    start = jnp.asarray(ps[:cardinality].astype(np.uint32))
    end = jnp.asarray((ps[1 : cardinality + 1] - 1).astype(np.uint32))

    for _depth in range(1, k):
        t0 = time.time()
        n = start.shape[0]
        if cardinality * n <= _CHUNK:
            start, end = _extend_all_letters(dev, start, end)
        else:
            starts, ends = [], []
            for lett in range(cardinality):
                for lo in range(0, n, _CHUNK):
                    hi = min(lo + _CHUNK, n)
                    s, e = _extend_chunk(
                        dev, start[lo:hi], end[lo:hi], np.int32(lett)
                    )
                    starts.append(s)
                    ends.append(e)
            start = jnp.concatenate(starts)
            end = jnp.concatenate(ends)
        if _DEBUG_TIMING:
            jax.block_until_ready(start)
            print(
                f"[seed] depth {_depth}: out={cardinality * n} "
                f"{time.time() - t0:.2f}s",
                flush=True,
            )

    return jnp.stack([start, end], axis=1)


def build_seed_table(dev, cardinality: int, k: int) -> np.ndarray:
    """Host (|A|^k, 2) uint64 seed table (pulls the device result)."""
    return np.asarray(build_seed_table_device(dev, cardinality, k)).astype(
        np.uint64
    )
