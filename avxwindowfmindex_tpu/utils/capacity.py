"""Device-memory capacity planner: size an index configuration to the card.

The reference documents exactly this sizing guidance for its users —
seed-table memory vs k, the suffix-array compression-ratio trade, and
the in-memory-SA option (the reference's README.md:188-213). Here the
budget is what the JAX allocator gives one process on the card, and the
knobs are richer (digram table, dense device-side SA, capacity modes),
so the guidance becomes a planner:

    plan = plan_capacity(num_bases, AlphabetType.DNA)
    cfg  = plan.index_configuration()          # -> IndexConfiguration
    plan.seed_k, plan.device_sa_ratio, plan.ngram, plan.engine

Sizing model (all byte counts exact, from the device packers in
models/index.py, ops/ngram.py and ops/rank64.py; workspace estimated):

    packed       num_blocks x device_row_bytes        (backtrace rows)
    packed_pair  num_blocks x device_pair_row_bytes   (one-gather steps)
    ngram        num_blocks x pair-row bytes of the n-gram table
                 (nucleotide, narrow only — ops/ngram.py geometry)
    seed_table   |A|^k x 8 B narrow / 16 B wide
    sampled_sa   ceil(bwt/ratio) x 4 B narrow / 8 B wide, at the DENSER
                 of (config ratio, device_sa_ratio) when dense SA is on
    workspace    batch x (kmer_len + 96) B live query/range/compaction
                 buffers + 256 MB XLA temp slack

Degradation ladder when the rich configuration does not fit. The order
is the value per byte the earlier accelerator rounds measured; it is
not measured on the H100 yet:

    1. lower seed_k toward MIN_SEED_K
    2. drop the dense device SA
    3. drop the digram table
    4. drop pair rows

Engine modes, in preference order (SURVEY.md §5 capacity story):
    replicated     index fits one card; query-sharded across the
                   mesh (parallel/dist.py). Wide layout auto-selected
                   for bwt >= 2^32.
    range_sharded  index exceeds one card but fits the mesh's
                   aggregate: blocks partitioned, psum rank
                   (parallel/range_sharded.py).
    chunked        narrow-kernel alternative for >= 2^32 corpora
                   (parallel/chunked.py); noted, never auto-picked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from ..models import alphabet as alpha
from ..models.config import AlphabetType
from . import devices

#: Largest seed k the planner will pick. DNA 14 is the largest k this
#: program has measured a gain at (k15's 8.6 GB table never was); the
#: choice is not measured on the H100 yet. Amino 6 caps the table at
#: 20^6*8 = 512 MB.
MAX_SEED_K = {AlphabetType.DNA: 14, AlphabetType.RNA: 14, AlphabetType.AMINO: 6}
MIN_SEED_K = {AlphabetType.DNA: 10, AlphabetType.RNA: 10, AlphabetType.AMINO: 2}

_XLA_SLACK_BYTES = 256 << 20


def detect_budget_bytes(device=None) -> Tuple[int, str]:
    """Allocator limit of the active JAX device, (bytes, source-note).

    Raises ``devices.UnknownDeviceError`` for a device kind without an
    entry in the device-facts table, the CPU included."""
    limit = devices.allocator_limit_bytes(device)
    return limit, f"allocator limit {limit / 1e9:.2f} GB (memory_stats)"


def component_bytes(
    num_bases: int,
    alphabet: AlphabetType = AlphabetType.DNA,
    *,
    seed_k: int,
    sa_ratio: int = 8,
    device_sa_ratio: Optional[int] = None,
    ngram: bool = False,
    ngram_n: int = 2,
    pair_rows: bool = True,
    wide: Optional[bool] = None,
) -> Dict[str, int]:
    """Exact per-component device bytes for one replicated index."""
    from ..models import index as index_mod

    bwt_length = num_bases + 1
    if wide is None:
        wide = bwt_length >= 2**32
    nb = index_mod.num_blocks_from_bwt_length(bwt_length)
    comp: Dict[str, int] = {}
    if wide:
        from ..ops import rank64 as r64

        comp["packed"] = nb * r64.device_row_bytes64(alphabet, pair=pair_rows)
    else:
        comp["packed"] = nb * index_mod.device_row_bytes(alphabet)
        if pair_rows:
            comp["packed_pair"] = nb * index_mod.device_pair_row_bytes(
                alphabet
            )
    if ngram:
        if alphabet == AlphabetType.AMINO or wide:
            raise ValueError(
                "the n-gram engine is nucleotide-only and narrow-only "
                "(search.py NgramSearchEngine guards)"
            )
        from ..ops import ngram as ngram_ops

        comp["ngram"] = nb * ngram_ops._geometry_pair(ngram_n)[4]
    entry = 16 if wide else 8  # (start, end) u32 pairs; u64 pairs wide
    comp["seed_table"] = (alpha.cardinality(alphabet) ** seed_k) * entry
    ratio = device_sa_ratio if device_sa_ratio else sa_ratio
    comp["sampled_sa"] = -(-bwt_length // ratio) * (8 if wide else 4)
    return comp


def workspace_bytes(batch: int, kmer_len: int) -> int:
    """Estimated live non-index device bytes during a search batch."""
    return batch * (kmer_len + 96) + _XLA_SLACK_BYTES


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """A sized configuration; see module docstring for the model."""

    num_bases: int
    alphabet: AlphabetType
    hbm_bytes: int  # per-card allocator budget the plan was sized to
    n_devices: int
    engine: str  # "replicated" | "range_sharded"
    wide: bool
    seed_k: int
    sa_ratio: int
    device_sa_ratio: Optional[int]  # None = keep the config ratio
    ngram: bool
    ngram_n: int
    pair_rows: bool
    components: Dict[str, int]
    index_bytes: int
    per_chip_bytes: int  # index share resident on one chip
    workspace: int
    budget: int  # fit_fraction * hbm_bytes - workspace
    fit_fraction: float
    notes: Tuple[str, ...]

    def index_configuration(self):
        from ..models.config import IndexConfiguration

        return IndexConfiguration(
            suffix_array_compression_ratio=self.sa_ratio,
            kmer_length_in_seed_table=self.seed_k,
            alphabet_type=self.alphabet,
        )

    def summary(self) -> str:
        gb = 1e9
        parts = ", ".join(
            f"{k}={v / gb:.2f}GB" for k, v in sorted(self.components.items())
        )
        return (
            f"{self.engine} engine ({self.n_devices} device"
            f"{'s' if self.n_devices != 1 else ''}, "
            f"{'wide' if self.wide else 'narrow'}): seed_k={self.seed_k}, "
            f"device_sa_ratio={self.device_sa_ratio}, "
            f"ngram={'on' if self.ngram else 'off'}, "
            f"pair_rows={'on' if self.pair_rows else 'off'}; "
            f"{self.per_chip_bytes / gb:.2f}GB/chip of "
            f"{self.budget / gb:.2f}GB budget ({parts})"
        )


def _candidates(alphabet, wide, max_k, min_k, dense_ratio):
    """Configs richest-first along the measured-value ladder."""
    ngram_ok = alphabet != AlphabetType.AMINO and not wide
    for ngram in ([True, False] if ngram_ok else [False]):
        for dense in ([dense_ratio, None] if dense_ratio else [None]):
            for k in range(max_k, min_k - 1, -1):
                yield dict(seed_k=k, device_sa_ratio=dense, ngram=ngram,
                           pair_rows=True)
    # last resorts: no pair rows
    for k in range(max_k, min_k - 1, -1):
        yield dict(seed_k=k, device_sa_ratio=None, ngram=False,
                   pair_rows=False)


def plan_capacity(
    num_bases: int,
    alphabet: AlphabetType = AlphabetType.DNA,
    *,
    hbm_bytes: Optional[int] = None,
    n_devices: int = 1,
    sa_ratio: int = 8,
    device_sa_ratio: Optional[int] = 4,
    batch: int = 1 << 22,
    kmer_len: int = 25,
    fit_fraction: float = 0.90,
    max_seed_k: Optional[int] = None,
    min_seed_k: Optional[int] = None,
    ngram_n: int = 2,
) -> CapacityPlan:
    """Pick seed_k / dense SA / digram / engine mode for the corpus.

    The degradation order (lower k, then drop dense SA, then digram,
    then pair rows) follows the ladder in the module docstring.
    ``hbm_bytes`` is the per-card budget; by default it is the active
    device's allocator limit (``detect_budget_bytes``).
    ``device_sa_ratio=None`` disables the dense-SA option entirely;
    ``fit_fraction`` is the share of that budget the resident index may
    use after the workspace estimate is reserved (a margin for
    fragmentation, not measured on the H100).
    """
    notes = []
    if hbm_bytes is None:
        hbm_bytes, src = detect_budget_bytes()
        notes.append(f"budget: {src}")
    bwt_length = num_bases + 1
    wide = bwt_length >= 2**32
    max_k = max_seed_k if max_seed_k is not None else MAX_SEED_K[alphabet]
    max_k = max(1, min(max_k, kmer_len))
    min_k = min_seed_k if min_seed_k is not None else MIN_SEED_K[alphabet]
    min_k = min(min_k, max_k)
    if device_sa_ratio and bwt_length // device_sa_ratio >= 2**31:
        # dense samples are gathered by int32 index (models/index.py
        # densify + build-time guards); past 2^31 samples the option
        # does not exist at any layout
        notes.append(
            f"dense device SA at ratio {device_sa_ratio} exceeds the "
            "int32 sample-gather limit; disabled"
        )
        device_sa_ratio = None
    ws = workspace_bytes(batch, kmer_len)
    budget = int(fit_fraction * hbm_bytes) - ws
    if budget <= 0:
        raise ValueError(
            f"workspace estimate {ws} exceeds {fit_fraction:.0%} of the "
            f"device budget ({hbm_bytes}); shrink the batch"
        )

    def build(cand, engine, chips):
        comp = component_bytes(
            num_bases, alphabet, sa_ratio=sa_ratio, ngram_n=ngram_n,
            wide=wide, **cand,
        )
        total = sum(comp.values())
        if engine == "replicated":
            per_chip = total
        else:
            # blocks + SA partitioned across the mesh; seed table and
            # prefix sums replicated (parallel/range_sharded.py header)
            sharded = total - comp["seed_table"]
            per_chip = -(-sharded // chips) + comp["seed_table"]
        return comp, total, per_chip

    for engine in ("replicated", "range_sharded"):
        if engine == "range_sharded" and n_devices < 2:
            continue
        for cand in _candidates(alphabet, wide, max_k, min_k,
                                device_sa_ratio):
            if engine == "range_sharded" and cand["ngram"]:
                continue  # range-sharded rank uses compact rows only
            comp, total, per_chip = build(cand, engine, n_devices)
            if per_chip <= budget:
                if engine == "range_sharded":
                    notes.append(
                        "index exceeds one card's budget; blocks+SA "
                        f"partitioned over {n_devices} devices"
                    )
                if wide:
                    notes.append(
                        "bwt >= 2^32: wide hi/lo layout; "
                        "parallel/chunked.py keeps narrow kernels if "
                        "the corpus can be chunked below 2^31 bases"
                    )
                return CapacityPlan(
                    num_bases=num_bases, alphabet=alphabet,
                    hbm_bytes=hbm_bytes, n_devices=n_devices,
                    engine=engine, wide=wide, sa_ratio=sa_ratio,
                    components=comp, index_bytes=total,
                    per_chip_bytes=per_chip, workspace=ws, budget=budget,
                    fit_fraction=fit_fraction, notes=tuple(notes),
                    ngram_n=ngram_n, **cand,
                )
    # nothing fits: report the smallest config's shortfall
    comp, total, per_chip = build(
        dict(seed_k=min_k, device_sa_ratio=None, ngram=False,
             pair_rows=False),
        "range_sharded" if n_devices > 1 else "replicated", n_devices,
    )
    need = math.ceil((total - comp["seed_table"])
                     / max(budget - comp["seed_table"], 1))
    raise ValueError(
        f"no configuration fits: minimal index needs {per_chip / 1e9:.2f}"
        f"GB/chip against a {budget / 1e9:.2f}GB budget; "
        f"needs a >= {need}-device mesh (range-sharded) or a smaller "
        f"corpus/batch"
    )
