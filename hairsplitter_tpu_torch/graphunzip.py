"""Standalone GraphUnzip-equivalent CLI (reference `src/GraphUnzip/graphunzip.py`)
of the PyTorch / CUDA port: the subcommands and flags of
`hairsplitter_tpu/graphunzip.py`, plus `--device` (default "cuda"; "cpu" runs
the plain PyTorch versions of the kernels) on the three that map reads.

Subcommands mirror the reference's user surface:

  unzip            untangle a GFA with long-read paths (GAF), optionally
                   repolishing duplicated copies with the reads
                   (reference `graphunzip.py unzip -g -l -r`, :296-481)
  hic-im           build a Hi-C interaction matrix by mapping both mates of
                   each pair in-process (reference `HiC-IM` subcommand :231;
                   the reference needs the reads pre-mapped with an external
                   aligner — here the built-in mapper does it)
  linked-reads-im  interaction matrix from barcoded linked reads (`BX:Z:` in
                   headers; reference `linked-reads-IM` :263)
  untangle-im      resolve ambiguous nodes with an interaction matrix
                   (the essence of the reference's solve_with_HiC path)

Usage examples:
  python -m hairsplitter_tpu_torch.graphunzip unzip -g in.gfa -l aln.gaf -r reads.fa -o out.gfa
  python -m hairsplitter_tpu_torch.graphunzip hic-im -g in.gfa -1 hic_R1.fa -2 hic_R2.fa -o im.npz
  python -m hairsplitter_tpu_torch.graphunzip untangle-im -g in.gfa -m im.npz -o out.gfa
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .core.mapping import map_reads
from .io.fasta import read_fasta, write_fasta
from .io.gaf import parse_gaf
from .io.gfa import bluntify_graph, gfa_to_fasta, parse_gfa, write_gfa
from .pipeline.dbg import dbg_unzip
from .pipeline.hic import interaction_matrix_from_pairs
from .pipeline.hic_solve import solve_with_interactions
from .pipeline.orchestrate import resolve_device
from .pipeline.unzip import (
    count_link_support,
    duplicate_contigs,
    duplicate_multiway,
    merge_linear_chains,
    remove_tips,
    remove_unsupported_links,
    repolish_copies,
)


def cmd_unzip(args) -> int:
    g = parse_gfa(args.gfa)
    read_paths, read_names = parse_gaf(args.gaf)
    print(f"{len(g.segments)} contigs, {len(read_paths)} informative read paths")
    support = count_link_support(read_paths)
    if args.exhaustive:
        removed = remove_unsupported_links(g, support)
        print(f"removed {removed} unsupported links (careful mode)")
    copy_of = duplicate_contigs(g, read_paths)
    print(f"duplicated into {len(copy_of)} extra copies")
    if args.reads and copy_of:
        seqs = read_fasta(args.reads)
        by_row = {
            i: seqs[n] for i, n in enumerate(read_names) if n in seqs
        }
        # the same re-polish as the in-process stage 6
        n = repolish_copies(g, copy_of, read_paths, by_row, device=resolve_device(args.device))
        print(f"repolished {n} duplicated contigs")
    if args.duplicate:
        n_dup = duplicate_multiway(g)
        print(f"-D: duplicated {n_dup} contig copies by topology")
    remove_tips(g)
    g.dedupe_links()
    if args.dont_merge:
        # reference --dont_merge (HairSplitter -s): duplicate but don't
        # merge unbranched chains (`graphunzip.py:468-477`)
        composition = {n: [(n, 1)] for n in g.segments}
    else:
        composition = merge_linear_chains(g)
    # export ordering (`input_output.py:379-383`): longest first, or
    # most-covered first with -x (amplicon mode, `graphunzip.py:468-472`)
    key = (lambda n: g.depths.get(n, 0.0)) if args.sort_coverage else (lambda n: len(g.segments[n]))
    g.segments = {n: g.segments[n] for n in sorted(g.segments, key=key, reverse=True)}
    write_gfa(g, args.out)
    if args.fasta:
        write_fasta(args.fasta, gfa_to_fasta(g))
    with open(args.supercontigs, "w") as f:
        for name, comp in composition.items():
            f.write(
                name + "\t" + ",".join(f"{n}{'+' if o == 1 else '-'}" for n, o in comp) + "\n"
            )
    print(f"done: {args.out} ({len(g.segments)} contigs)")
    return 0


def _map_best_contig(contigs, seqs, device):
    """Best contig per read (or None) via the built-in mapper on `device`."""
    best: dict[int, tuple[int, str]] = {}
    for a in map_reads(contigs, seqs, device=device):
        span = a.t_end - a.t_start
        if a.read_idx not in best or span > best[a.read_idx][0]:
            best[a.read_idx] = (span, a.contig)
    return {i: c for i, (_, c) in best.items()}


def cmd_dbg(args) -> int:
    """Contig-space de Bruijn untangling (reference `contig_DBG.py:373`
    `DBG_long_reads` / `solve_with_long_reads.py:27` capability — their
    call sites are commented out in the reference CLI, `graphunzip.py:20,
    404-420`; exposed here as a first-class subcommand)."""
    g = parse_gfa(args.gfa)
    read_paths, _names = parse_gaf(args.gaf)
    print(f"{len(g.segments)} contigs, {len(read_paths)} informative read paths")
    out = dbg_unzip(
        g, read_paths, k_max=args.kmax, chunk=args.chunk, min_abundance=args.min_abundance
    )
    if args.blunt:
        trimmed = bluntify_graph(out)
        print(f"bluntified: trimmed {trimmed} overlap bases")
    out.segments = {
        n: out.segments[n]
        for n in sorted(out.segments, key=lambda n: len(out.segments[n]), reverse=True)
    }
    write_gfa(out, args.out)
    if args.fasta:
        write_fasta(args.fasta, gfa_to_fasta(out))
    print(f"done: {args.out} ({len(out.segments)} contigs)")
    return 0


def cmd_hic_im(args) -> int:
    device = resolve_device(args.device)
    g = parse_gfa(args.gfa)
    r1 = list(read_fasta(args.r1).values())
    r2 = list(read_fasta(args.r2).values())
    n = min(len(r1), len(r2))
    hit1 = _map_best_contig(g.segments, r1[:n], device)
    hit2 = _map_best_contig(g.segments, r2[:n], device)
    pairs = [(hit1[i], hit2[i]) for i in range(n) if i in hit1 and i in hit2]
    im = interaction_matrix_from_pairs(list(g.segments), pairs)
    np.savez(args.out, names=np.asarray(im.names, dtype=object), m=im.m)
    print(f"{len(pairs)} informative pairs -> {args.out}")
    return 0


def cmd_linked_im(args) -> int:
    device = resolve_device(args.device)
    g = parse_gfa(args.gfa)
    seqs = read_fasta(args.reads)
    names = list(seqs)
    hits = _map_best_contig(g.segments, [seqs[n] for n in names], device)
    barcodes: dict[str, set[str]] = {}
    for i, rn in enumerate(names):
        if i not in hits:
            continue
        bx = [p for p in rn.split() if p.startswith("BX:Z:")]
        if bx:
            barcodes.setdefault(bx[0][5:], set()).add(hits[i])
    pairs = []
    for members in barcodes.values():
        members = sorted(members)
        for i in range(len(members)):
            for j in range(i + 1, len(members)):
                pairs.append((members[i], members[j]))
    im = interaction_matrix_from_pairs(list(g.segments), pairs)
    np.savez(args.out, names=np.asarray(im.names, dtype=object), m=im.m)
    print(f"{len(barcodes)} barcodes, {len(pairs)} contig pairs -> {args.out}")
    return 0


def cmd_untangle_im(args) -> int:
    g = parse_gfa(args.gfa)
    data = np.load(args.matrix, allow_pickle=True)
    rep = solve_with_interactions(g, list(data["names"]), data["m"])
    merge_linear_chains(g)
    write_gfa(g, args.out)
    print(
        f"solved {rep.knots_solved}/{rep.knots_seen} knots in {rep.rounds} rounds, "
        f"duplicated {rep.contigs_duplicated} contigs -> {args.out} ({len(g.segments)} contigs)"
    )
    return 0


def _add_device(parser) -> None:
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device of the read mapping (default cuda; cpu runs the "
        "plain PyTorch versions of the kernels)",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="graphunzip", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    u = sub.add_parser("unzip", help="untangle a GFA with long-read paths (GAF)")
    u.add_argument("-g", "--gfa", required=True)
    u.add_argument("-l", "--gaf", required=True, help="read paths (GAF)")
    u.add_argument("-r", "--reads", default="", help="reads FASTA (enables repolish)")
    u.add_argument("-o", "--out", default="output.gfa")
    u.add_argument("-f", "--fasta", default="", help="optional FASTA output")
    u.add_argument("-e", "--exhaustive", action="store_true", help="remove unsupported links")
    u.add_argument(
        "-D",
        "--duplicate",
        action="store_true",
        help="duplicate contigs by topology+coverage (reference finish_untangling.py:223)",
    )
    u.add_argument(
        "--dont_merge",
        action="store_true",
        help="don't merge unbranched chains after duplication (reference "
        "--dont_merge; HairSplitter -s passes this, hairsplitter.py:806-816)",
    )
    u.add_argument(
        "-x",
        "--sort-coverage",
        action="store_true",
        help="sort exported contigs by coverage instead of length "
        "(amplicon mode, reference graphunzip.py:468-472)",
    )
    u.add_argument("--supercontigs", default="supercontigs.txt")
    _add_device(u)
    u.set_defaults(fn=cmd_unzip)

    d = sub.add_parser(
        "dbg",
        help="contig-space de Bruijn untangling from long-read paths "
        "(reference contig_DBG.py DBG_long_reads capability)",
    )
    d.add_argument("-g", "--gfa", required=True)
    d.add_argument("-l", "--gaf", required=True, help="read paths (GAF)")
    d.add_argument("-o", "--out", default="output.gfa")
    d.add_argument("-f", "--fasta", default="", help="optional FASTA output")
    d.add_argument("-k", "--kmax", type=int, default=9, help="max symbol k (reference stops at 9)")
    d.add_argument("--chunk", type=int, default=1000, help="contig chunk size in bp")
    d.add_argument("--min-abundance", type=int, default=1)
    d.add_argument(
        "--blunt", action="store_true", help="trim overlap links to 0M after untangling"
    )
    d.set_defaults(fn=cmd_dbg)

    h = sub.add_parser("hic-im", help="Hi-C interaction matrix (mates mapped in-process)")
    h.add_argument("-g", "--gfa", required=True)
    h.add_argument("-1", dest="r1", required=True)
    h.add_argument("-2", dest="r2", required=True)
    h.add_argument("-o", "--out", default="hic_im.npz")
    _add_device(h)
    h.set_defaults(fn=cmd_hic_im)

    l = sub.add_parser("linked-reads-im", help="interaction matrix from BX-barcoded reads")
    l.add_argument("-g", "--gfa", required=True)
    l.add_argument("-r", "--reads", required=True)
    l.add_argument("-o", "--out", default="linked_im.npz")
    _add_device(l)
    l.set_defaults(fn=cmd_linked_im)

    t = sub.add_parser("untangle-im", help="resolve ambiguities with an interaction matrix")
    t.add_argument("-g", "--gfa", required=True)
    t.add_argument("-m", "--matrix", required=True)
    t.add_argument("-o", "--out", default="output.gfa")
    t.set_defaults(fn=cmd_untangle_im)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
