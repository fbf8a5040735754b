"""Host-side data model for alignments and pileups.

Plays the role of the reference's `Read`/`Overlap` structs (`src/read.h:12-77`)
but keeps CIGARs as numpy run-length arrays and read references as indices into
a :class:`~hairsplitter_tpu_torch.io.fasta.ReadStore`.

Copy of `hairsplitter_tpu/core/datatypes.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.cigar import CONSUMES_QUERY, CONSUMES_TARGET, cigar_to_string


@dataclass
class Alignment:
    """One read-to-contig alignment (the reference's `Overlap`, `src/read.h`).

    Coordinates follow the COL/GRO convention (`doc/README.md`):
    q_start/q_end on the forward-strand read, t_start/t_end on the contig,
    strand 1 = forward, 0 = reverse. The CIGAR is in the orientation of the
    contig (query = reverse-complemented read when strand == 0).
    """

    read_idx: int
    contig: str
    strand: int
    q_start: int
    q_end: int
    t_start: int
    t_end: int
    cigar_ops: np.ndarray = field(repr=False)
    cigar_lens: np.ndarray = field(repr=False)
    nm: int = 0  # edit distance over the aligned region

    @property
    def cigar(self) -> str:
        return cigar_to_string(self.cigar_ops, self.cigar_lens)

    def aligned_query_span(self) -> int:
        return int(self.cigar_lens[CONSUMES_QUERY[self.cigar_ops]].sum())

    def aligned_target_span(self) -> int:
        return int(self.cigar_lens[CONSUMES_TARGET[self.cigar_ops]].sum())
