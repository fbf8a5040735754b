"""COL / GRO interop (the reference's documented intermediate formats).

Copy of `hairsplitter_tpu/io/col_gro.py` (that module loads JAX through its
pipeline imports); it reads and writes the port's ContigVariants and
ContigGroups. Spec: `doc/README.md` of the reference — alleles are written
as integers in [0, 255] (trimer codes).
"""

from __future__ import annotations

import numpy as np

from ..core.datatypes import Alignment

from ..pipeline.call_variants import ContigVariants, SparseColumn
from ..pipeline.separate_reads import ContigGroups, WindowGroups

def write_col(
    path: str,
    variants: dict[str, ContigVariants],
    alignments: dict[str, list[Alignment]],
    read_names: dict[int, str],
) -> None:
    """Copy of `hairsplitter_tpu/io/col_gro.py:write_col`."""
    with open(path, "w") as f:
        for contig, cv in variants.items():
            f.write(f"CONTIG\t{contig}\t{cv.length}\t{cv.depth:.6g}\n")
            for a in alignments.get(contig, []):
                f.write(
                    f"READ\t{read_names.get(a.read_idx, f'read_{a.read_idx}')}\t"
                    f"{a.q_start}\t{a.q_end}\t{a.t_start}\t{a.t_end}\t{a.strand}\n"
                )
            for c in cv.columns:
                idxs = ",".join(str(int(r)) for r in c.rows) + ","
                alleles = ",".join(str(int(x)) for x in c.alleles) + ","
                f.write(f"SNPS\t{c.pos}\t{c.top1}\t{c.top2}\t{idxs}\t{alleles}\n")


def read_col(path: str) -> dict[str, ContigVariants]:
    """Copy of `hairsplitter_tpu/io/col_gro.py:read_col`."""
    out: dict[str, ContigVariants] = {}
    cv = None
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts[0] == "CONTIG":
                cv = ContigVariants(
                    contig=parts[1],
                    length=int(parts[2]),
                    depth=float(parts[3]),
                    error_rate=0.0,
                )
                out[parts[1]] = cv
            elif parts[0] == "READ" and cv is not None:
                cv.n_reads += 1
            elif parts[0] == "SNPS" and cv is not None:
                rows = np.array([int(x) for x in parts[4].split(",") if x], dtype=np.int64)
                alleles = np.array([int(x) for x in parts[5].split(",") if x], dtype=np.int16)
                cv.columns.append(
                    SparseColumn(
                        pos=int(parts[1]),
                        top1=int(parts[2]),
                        top2=int(parts[3]),
                        rows=rows,
                        alleles=alleles.astype(np.int8),
                    )
                )
    return out


def write_gro(
    path: str,
    groups: dict[str, ContigGroups],
    alignments: dict[str, list[Alignment]],
    read_names: dict[int, str],
) -> None:
    """Copy of `hairsplitter_tpu/io/col_gro.py:write_gro`."""
    with open(path, "w") as f:
        for contig, cg in groups.items():
            f.write(f"CONTIG\t{contig}\t{cg.length}\t{cg.depth:.6g}\n")
            for a in alignments.get(contig, []):
                f.write(
                    f"READ\t{read_names.get(a.read_idx, f'read_{a.read_idx}')}\t"
                    f"{a.q_start}\t{a.q_end}\t{a.t_start}\t{a.t_end}\t{a.strand}\n"
                )
            for w in cg.windows:
                present = np.nonzero(w.labels != -2)[0]
                idxs = ",".join(str(int(r)) for r in present) + ","
                labs = ",".join(str(int(w.labels[r])) for r in present) + ","
                f.write(f"GROUP\t{w.start}\t{w.end}\t{idxs}\t{labs}\n")


def read_gro(path: str) -> dict[str, ContigGroups]:
    """Copy of `hairsplitter_tpu/io/col_gro.py:read_gro`."""
    out: dict[str, ContigGroups] = {}
    cg = None
    n_reads = 0
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts[0] == "CONTIG":
                cg = ContigGroups(contig=parts[1], length=int(parts[2]), depth=float(parts[3]))
                out[parts[1]] = cg
                n_reads = 0
            elif parts[0] == "READ":
                n_reads += 1
            elif parts[0] == "GROUP" and cg is not None:
                idxs = [int(x) for x in parts[3].split(",") if x]
                labs = [int(x) for x in parts[4].split(",") if x]
                labels = np.full(n_reads, -2, dtype=np.int64)
                for r, g in zip(idxs, labs):
                    if r < n_reads:
                        labels[r] = g
                cg.windows.append(WindowGroups(int(parts[1]), int(parts[2]), labels))
    return out
