"""Band geometry and codes of the banded DP.

Copied from `hairsplitter_tpu/ops/align.py:33-65` because that module loads
JAX; values and semantics are identical.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INF = np.int32(1 << 20)
Q_SENTINEL = 7  # query padding code (never equals target)
T_SENTINEL = 6  # target padding code

# expanded traceback op codes (match io.cigar OPS order '=XIDMSH')
TB_EQ, TB_X, TB_I, TB_D = 0, 1, 2, 3
# backpointer codes stored by the DP kernel
BP_DIAG, BP_UP, BP_LEFT = 0, 1, 2


@dataclass(frozen=True)
class BandSpec:
    """Geometry of the banded DP.

    chunk: max query length B per chunk; band: band width W.
    The band covers target offsets j - i in [-dl, dr]."""

    chunk: int = 256
    band: int = 128

    @property
    def dl(self) -> int:
        return self.band // 2

    @property
    def dr(self) -> int:
        return self.band - 1 - self.band // 2

    @property
    def t_width(self) -> int:
        # target buffer width: j ranges up to qlen + dr <= chunk + dr
        return self.chunk + self.dr
