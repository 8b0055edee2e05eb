"""Kernel-formulation env knobs, read in ONE place.

Every knob selects between bit-identical formulations (parity-tested).
The defaults won on the accelerator this engine was first tuned on and
the losers stay opt-in; none of these choices is measured on the H100
yet (ROADMAP C6). docs/CONFIG.md lists them all. All readers are
evaluated at trace time of the jitted step programs.
"""

import os


def use_ms_wsum() -> bool:
    """Weighted-byte-sum milestone select — DEFAULT ON (AWFM_MS_WSUM=0
    opts back into the bitcast one-hot form). Replaces the u8->u32
    `bitcast_convert_type` layout change + per-word column selects with one
    fusable widen * byte-weight * word-mask reduce (exact mod 2^32)."""
    return os.environ.get("AWFM_MS_WSUM", "1") == "1"


def use_occ_dot() -> bool:
    """Opt-in matmul occurrence reduce (AWFM_OCC_DOT=1): popcount sums
    as int8 block-ones matmuls. Checked BEFORE the u32-lane knob
    everywhere so a both-knobs-set sweep is unambiguous."""
    return os.environ.get("AWFM_OCC_DOT", "0") == "1"


def use_u32_lanes(var: str) -> bool:
    """Opt-in u32-lane match/mask/popcount (AWFM_NGRAM_U32=1 for the
    n-gram kernels, AWFM_RANK_U32=1 for the single-letter kernels); the
    gathered u8 rows are bitcast to u32 words first."""
    return os.environ.get(var, "0") == "1"
