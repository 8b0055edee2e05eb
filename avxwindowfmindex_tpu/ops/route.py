"""Slab-routed row gathers: through the big-table gather wall.

Mechanism: on the accelerator this engine was first tuned on, XLA
gathered full rows from small operands (tens of MiB) far faster than
from large ones, whose gathers ran at a flat issue-rate wall whatever
the touched working set. Sorting the batch's block ids and gathering
each contiguous run from a bounded ``dynamic_slice`` slab recovered
most of the small-operand rate, sort included. Whether the H100 has
such a wall, and where, is not measured yet (ROADMAP C5); the
thresholds below are not derived for it.

This module is the production driver for that routing:

    plan = plan_for(n_rows, row_bytes, batch)      # host, trace-time
    rows, covered = routed_gather(table, blk_sorted, plan)

``routed_gather`` scans over K slabs; per slab it slices the (cap,)
window of sorted block ids, gathers the rows from the sliced slab
operand, and assembles them with contiguous ``dynamic_update_slice``
writes (a window's overhang rows belong to the NEXT slab and are
overwritten by its in-order write). Inputs must be pre-sorted by block
id; results come back in that sorted order — callers carry an
origin-index payload through their routing sorts and restore once at
the end of their loop (scatter-based reassembly, per-step restore sorts
and per-step payload gathers each cost a large share of a mono step, so
everything rides the sort operands).

Exactness: a slab run longer than the static ``cap`` truncates; those
rows come back with ``covered=False`` and garbage content, and every
caller routes them into an existing exact redo net (the digram
pair-step ``bad`` fixup; the backtrace's final while_loop net).
Uniform-ish positions (LF walks, spread ranges) overflow a 25%-slack
cap with ~0 probability; adversarially clustered batches degrade to
the redo path, never to wrong answers.

The corresponding hot-path integrations live next to their mono
formulations: rank.letter_and_lf_from_rows + search routed backtrace,
ngram routed pair step. Reference anchor: this accelerates the block
fetch of AwFmOccurrence.c:52-135 / AwFmSearch.c:57-58; the reference
has no equivalent concern (CPU caches handle its working set).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    sr: int  # rows per slab
    k: int  # number of slabs
    cap: int  # static per-slab window (rows)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def route_mode() -> str:
    """AWFM_ROUTE: 'auto' (default; the break-even policy of plan_for),
    '1' force-on (tests), '0' off."""
    return os.environ.get("AWFM_ROUTE", "auto")




def plan_for(
    n_rows: int, row_bytes: int, batch: int
) -> Optional[RoutePlan]:
    """Routing decision + geometry for one gather site (host-side; the
    batch size is a static shape, so this is a trace-time decision).

    auto policy. Its thresholds were set on the accelerator this
    engine was first tuned on and are NOT derived for the H100 (ROADMAP
    C5); at chromosome scale it never routes there:
      - rows must be narrow (<= AWFM_ROUTE_MAX_ROW_BYTES, default 128):
        the materialized (B, row_bytes) buffer's write+read grows with
        row width and cancels the gather win for wide rows;
      - the table must be large (>= AWFM_ROUTE_MIN_BYTES, default
        192 MiB);
      - the batch must amortize the per-step slab streaming: break-even
        at batch ~ table_bytes/AWFM_ROUTE_MIN_RATIO (default 5000),
        floored at AWFM_ROUTE_MIN_BATCH (256k).
    Slabs are AWFM_ROUTE_SLAB_BYTES (48 MiB); cap carries
    AWFM_ROUTE_CAP_SLACK % (25) over the uniform share.
    """
    mode = route_mode()
    if mode == "0":
        return None
    slab_bytes = _env_int("AWFM_ROUTE_SLAB_BYTES", 48 << 20)
    sr = max(1, slab_bytes // row_bytes)
    if n_rows <= sr:
        return None  # single slab == the mono gather
    if mode != "1":
        if row_bytes > _env_int("AWFM_ROUTE_MAX_ROW_BYTES", 128):
            return None
        table_bytes = n_rows * row_bytes
        if table_bytes < _env_int("AWFM_ROUTE_MIN_BYTES", 192 << 20):
            return None
        min_batch = max(
            _env_int("AWFM_ROUTE_MIN_BATCH", 1 << 18),
            table_bytes // max(1, _env_int("AWFM_ROUTE_MIN_RATIO", 5000)),
        )
        if batch < min_batch:
            return None
    k = -(-n_rows // sr)
    slack = _env_int("AWFM_ROUTE_CAP_SLACK", 25)
    cap = min(batch, -(-batch * (100 + slack) // (100 * k)))
    # tiny windows spend more on slicing than gathering; route anyway
    # under force-on (parity tests on toy tables)
    if mode != "1" and cap < 1024:
        return None
    return RoutePlan(sr=sr, k=k, cap=cap)


def min_routed_batch(
    n_rows: int, row_bytes: int, hi: int = 1 << 24
) -> Optional[int]:
    """Smallest batch at which ``plan_for`` routes this table, or None
    if it never routes (up to ``hi``). Exact: binary search over the
    policy itself, so callers (bench roofline split) never re-derive
    the thresholds. plan_for is monotone in batch: the min-batch gate
    and the cap >= 1024 gate both relax as batch grows."""
    if plan_for(n_rows, row_bytes, hi) is None:
        return None
    lo = 1
    while lo < hi:
        mid = (lo + hi) // 2
        if plan_for(n_rows, row_bytes, mid) is None:
            lo = mid + 1
        else:
            hi = mid
    return lo


def routed_gather(table, blk_sorted, plan: RoutePlan):
    """Materialize the rows of ``blk_sorted`` via per-slab gathers.

    Returns ``(rows, covered)``: rows is (b, row_bytes) aligned with the
    sorted input; ``covered`` is False for any row whose slab run
    exceeded the static ``cap`` window (its content is then garbage and
    the caller must neutralize it — the digram step ORs ~covered into
    its ``bad`` fixup flag, the backtrace leaves uncovered rows
    unstepped for the exactness net). This per-row flag replaced a
    whole-batch `lax.cond` mono fallback, which cost a large share of a
    step; uniform batches never overflow a 25%-slack cap, so exactness
    via the callers' existing redo nets is cheaper.

    Gather-ONLY routing: the scan body holds nothing but the sliced
    slab and a (cap, row_bytes) window write, so XLA keeps the slab
    operand fast; compute runs ONCE on the returned buffer at
    full-batch efficiency (the same compute inside the scan was
    several times slower). The materialized buffer costs one extra
    write and read of (B, row_bytes).
    """
    b = blk_sorted.shape[0]
    n_rows = table.shape[0]
    rb = table.shape[1]
    sr, k, cap = plan.sr, plan.k, plan.cap

    # out-of-range ids (wrapped start-1 positions) clamp to the last row,
    # matching XLA's mono-gather clamp; clamping preserves sortedness and
    # keeps the window assignment consistent with the covered mask
    blk_sorted = jnp.minimum(blk_sorted, jnp.int32(n_rows - 1))

    bounds = jnp.arange(1, k, dtype=jnp.int32) * jnp.int32(sr)
    starts = jnp.searchsorted(blk_sorted, bounds).astype(jnp.int32)
    starts_full = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), starts, jnp.full((1,), b, jnp.int32)]
    )

    blk_pad = jnp.concatenate(
        [blk_sorted, jnp.full((cap,), n_rows - 1, blk_sorted.dtype)]
    )
    out = jnp.zeros((b + cap, rb), table.dtype)

    def body(carry, kk):
        s = starts_full[kk]
        base = jnp.minimum(kk * jnp.int32(sr), jnp.int32(n_rows - sr))
        win = lax.dynamic_slice(blk_pad, (s,), (cap,))
        local = jnp.clip(win - base, 0, sr - 1)
        slab = lax.dynamic_slice(table, (base, jnp.int32(0)), (sr, rb))
        return (
            lax.dynamic_update_slice(carry, slab[local], (s, jnp.int32(0))),
            None,
        )

    out, _ = lax.scan(body, out, jnp.arange(k, dtype=jnp.int32))

    # covered[i]: i sits within the first `cap` rows of its slab's run.
    # run starts via a cummax over slab-boundary markers — no per-row
    # gather from starts_full (small-table gathers are issue-bound like
    # any other gather; a cummax is a cheap log-pass scan).
    iota = jnp.arange(b, dtype=jnp.int32)
    slab = blk_sorted // jnp.int32(sr)
    new_run = jnp.concatenate(
        [jnp.zeros((1,), bool), slab[1:] != slab[:-1]]
    )
    run_start = lax.cummax(jnp.where(new_run, iota, 0))
    covered = (iota - run_start) < jnp.int32(cap)
    return out[:b], covered
