"""Chunked-corpus indexing: databases beyond the uint32 device limit.

The reference supports arbitrary 64-bit sequences by using uint64
everywhere (at AVX2 speeds). The device engine keeps device positions
uint32 for bandwidth; databases larger than 2^32-1 positions (or larger
than one card wants to hold) are instead split into overlapping
sub-indexes:

  - chunk i covers [i*chunk_bases, i*chunk_bases + chunk_bases
    + overlap), with overlap >= max query length - 1 so matches that
    straddle a boundary are found in the earlier chunk;
  - a hit is attributed to the chunk where it STARTS inside the
    non-overlap span, so nothing is double-counted;
  - count/locate fan out over the sub-indexes (each of which can also
    be device-replicated or mesh-sharded) and merge with global offsets.

Matching semantics are identical to one big index except that matches
may not span more than `overlap + 1` positions across a chunk boundary
— choose `overlap` >= your longest query.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..build import create_index
from ..models.config import IndexConfiguration
from ..search import SearchEngine


class ChunkedCorpusIndex:
    """A list of overlapping sub-indexes behaving like one big index."""

    def __init__(self, engines: List[SearchEngine], chunk_bases: int,
                 overlap: int, total_bases: int):
        self.engines = engines
        self.chunk_bases = chunk_bases
        self.overlap = overlap
        self.total_bases = total_bases
        # raw text of each junction (the first `overlap` bases of chunks
        # 1..C-1); enables the O(1)-per-kmer count() correction
        self.junction_texts: List[bytes] = []
        # lazily-built tiny sub-engines over each junction
        self._junction_engines: Optional[List[SearchEngine]] = None

    @classmethod
    def build(
        cls,
        sequence: Union[bytes, np.ndarray],
        config: Optional[IndexConfiguration] = None,
        chunk_bases: int = (1 << 31),
        overlap: int = 255,
        engine_factory=SearchEngine,
    ) -> "ChunkedCorpusIndex":
        if isinstance(sequence, np.ndarray):
            sequence = sequence.tobytes()
        total = len(sequence)
        if chunk_bases < 1 or overlap < 0:
            raise ValueError("chunk_bases must be >=1 and overlap >= 0")
        engines = []
        junctions = []
        for start in range(0, total, chunk_bases):
            chunk = sequence[start : start + chunk_bases + overlap]
            engines.append(engine_factory(create_index(chunk, config)))
            if start > 0:
                junctions.append(sequence[start : start + overlap])
        out = cls(engines, chunk_bases, overlap, total)
        out.junction_texts = junctions
        return out

    @property
    def num_chunks(self) -> int:
        return len(self.engines)

    def _check_query_lengths(self, kmers) -> None:
        max_len = max((len(k) for k in kmers), default=0)
        if max_len > self.overlap + 1 and self.num_chunks > 1:
            raise ValueError(
                f"query length {max_len} exceeds chunk overlap + 1 "
                f"({self.overlap + 1}); rebuild with a larger overlap"
            )

    def locate(self, kmers: Sequence[Union[str, bytes]]) -> List[np.ndarray]:
        """Global hit positions per kmer, merged across chunks."""
        self._check_query_lengths(kmers)
        merged: List[List[np.ndarray]] = [[] for _ in kmers]
        for i, engine in enumerate(self.engines):
            offset = i * self.chunk_bases
            for j, hits in enumerate(engine.locate(kmers)):
                # attribute a hit to the chunk where it starts inside the
                # non-overlap span (the overlap's copies belong to the
                # NEXT chunk's head)
                local = hits[hits < self.chunk_bases]
                if len(local):
                    merged[j].append(local.astype(np.uint64) + offset)
        return [
            np.sort(np.concatenate(parts)) if parts
            else np.empty(0, dtype=np.uint64)
            for parts in merged
        ]

    def _junctions(self) -> List[SearchEngine]:
        """Tiny sub-engines over each junction string, built on demand.

        A junction is <= `overlap` bases, so these indexes are a few KB;
        the seed table is shrunk accordingly (seed k capped at 6) and the
        SA is irrelevant (count never backtraces).
        """
        if self._junction_engines is None:
            base_cfg = self.engines[0].dev
            cfg = IndexConfiguration(
                suffix_array_compression_ratio=1,
                kmer_length_in_seed_table=min(
                    base_cfg.kmer_length_in_seed_table, 6
                ),
                alphabet_type=base_cfg.alphabet,
            )
            self._junction_engines = [
                SearchEngine(create_index(text, cfg))
                for text in self.junction_texts
            ]
        return self._junction_engines

    def count(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """Occurrence counts per kmer — O(1) per kmer per chunk.

        Sum of per-chunk range lengths, minus the double-counted matches.
        A match is counted by both chunk i (in its overlap tail) and
        chunk i+1 (at its head) exactly when it fits wholly within the
        first `overlap` bases of chunk i+1 — chunk i's window ends there,
        so any match extending past it exists only in chunk i+1. That
        correction is therefore an exact count over a FIXED tiny string
        (the junction), answered by a sub-index range length — no
        locate/backtrace anywhere (the reference's count is likewise
        range arithmetic only, AwFmParallelSearch.c:187-190).
        """
        self._check_query_lengths(kmers)
        if (
            self.num_chunks > 1
            and self.overlap > 0
            and len(self.junction_texts) != self.num_chunks - 1
        ):
            # constructed without junction texts (direct __init__):
            # fall back to the locate-derived count
            return np.array(
                [len(h) for h in self.locate(kmers)], dtype=np.uint64
            )
        total = np.zeros(len(kmers), dtype=np.uint64)
        for engine in self.engines:
            total += engine.count(kmers)
        if self.num_chunks > 1 and self.overlap > 0:
            for jeng in self._junctions():
                total -= jeng.count(kmers)
        return total
