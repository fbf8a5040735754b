"""Stage 6 entry: untangle the zipped graph with read paths, re-polishing
duplicated copies on the port's mapper.

Port of `repolish_copies` and `unzip` of `hairsplitter_tpu/pipeline/unzip.py`;
the graph helpers (link support, duplication, tips, chain merging) are
reused from that module, which loads without JAX.
"""

from __future__ import annotations

import numpy as np

from hairsplitter_tpu.constants import encode_seq
from hairsplitter_tpu.io.gfa import AssemblyGraph
from hairsplitter_tpu.ops.triage import BACKBONE_GOOD, check_backbone
from hairsplitter_tpu.pipeline.pileup import alignment_cells_full, orient_read
from hairsplitter_tpu.pipeline.unzip import (
    UnzipResult,
    count_link_support,
    duplicate_contigs,
    merge_linear_chains,
    remove_tips,
    remove_unsupported_links,
)

from ..core.mapping import map_reads
from ..ops.consensus import polish_iterative
from ..ops.poa import polish_poa
from ..ops.triage import select_backbone


def repolish_copies(g, copy_of, read_paths, read_seqs_by_row, *, device) -> int:
    """Re-polish duplicated copies with the reads whose paths traverse them
    (`pipeline/unzip.py:repolish_copies`, reference `repolish.py:102-467`);
    structural divergence goes through the triage tournament."""
    split_names = set(copy_of) | set(copy_of.values())
    by_contig: dict[str, list[int]] = {}
    for ridx, path in read_paths.items():
        for name, _ in path:
            if name in split_names:
                by_contig.setdefault(name, []).append(ridx)
    n = 0
    for name, rows in by_contig.items():
        if name not in g.segments:
            continue  # canceled-path slots can reference deleted roots
        reads = [read_seqs_by_row[r] for r in set(rows) if r in read_seqs_by_row]
        if len(reads) < 2:
            continue
        backbone = g.segments[name]
        alns = map_reads({name: backbone}, reads, device=device)
        code = BACKBONE_GOOD
        if len(alns) >= 2 and len(backbone) >= 200:
            code = check_backbone(
                alns, [len(reads[a.read_idx]) for a in alns], 0, len(backbone) - 1
            )
        if code != BACKBONE_GOOD:
            cells, inss = [], []
            for a in alns:
                oriented = orient_read(encode_seq(reads[a.read_idx]), a.strand)
                tpos, tri, it, ic = alignment_cells_full(a, oriented)
                cells.append((tpos, (np.asarray(tri, np.int16) // 25).astype(np.int8)))
                inss.append((it, ic))
            baseline = polish_iterative(backbone, reads, rounds=2, min_len=50, device=device)
            polished = select_backbone(
                code,
                encode_seq(backbone),
                0,
                len(backbone) - 1,
                cells,
                inss,
                alns,
                [reads[a.read_idx] for a in alns],
                [a.strand for a in alns],
                baseline,
                device=device,
            )
        else:
            polished = polish_iterative(backbone, reads, rounds=2, device=device)
            # the reference racon-polishes here (repolish.py:246,282); on
            # noisy reads the POA pass is what reaches racon's accuracy
            if alns:
                err = float(np.mean([a.nm / max(1, a.q_end - a.q_start) for a in alns]))
                if err > 0.10:
                    polished = polish_poa(polished, reads, rounds=1, device=device)
        if polished and polished != backbone:
            g.segments[name] = polished
            n += 1
    return n


def unzip(
    g: AssemblyGraph,
    read_paths: dict[int, list[tuple[str, int]]],
    careful: bool = True,
    merge: bool = True,
    read_seqs=None,
    *,
    device,
) -> UnzipResult:
    """Untangle with read paths (`pipeline/unzip.py:unzip`); with `read_seqs`
    the duplicated copies are re-polished from their own path's reads."""
    support = count_link_support(read_paths)
    if careful:
        remove_unsupported_links(g, support)
    copy_of = duplicate_contigs(g, read_paths)
    if read_seqs is not None and copy_of:
        repolish_copies(g, copy_of, read_paths, read_seqs, device=device)
    remove_tips(g)
    g.dedupe_links()
    if merge:
        composition = merge_linear_chains(g)
    else:
        composition = {n: [(n, 1)] for n in g.segments}
    return UnzipResult(graph=g, supercontigs=composition)
