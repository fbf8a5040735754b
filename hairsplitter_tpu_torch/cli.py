"""Command-line interface of the PyTorch / CUDA port: the flags of
`hairsplitter_tpu/cli.py` (the reference `hairsplitter.py:25-59`), plus
`--device` (default "cuda"; "cpu" runs the plain PyTorch versions) and
`--devices N` (one job over N cards, one process each).

Usage:
    python -m hairsplitter_tpu_torch.cli -i assembly.gfa -f reads.fastq -o out_dir
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .pipeline.orchestrate import PipelineConfig, run_pipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="hairsplitter_tpu_torch",
        description="Haplotype splitter on PyTorch + CUDA (capabilities of HairSplitter)",
    )
    p.add_argument("-i", "--assembly", required=True, help="Original assembly (GFA or FASTA)")
    p.add_argument("-f", "--fastq", required=True, help="Sequencing reads (FASTA/FASTQ, .gz ok)")
    p.add_argument("-o", "--output", required=True, help="Output directory")
    p.add_argument(
        "-x", "--technology", default="ont", choices=["ont", "pacbio", "hifi", "amplicon"]
    )
    p.add_argument("-t", "--threads", type=int, default=1, help="host threads (device ops are batched)")
    p.add_argument(
        "-s", "--dont_simplify", action="store_true",
        help="untangle without merging adjacent contigs (reference passes "
        "--dont_merge to GraphUnzip, hairsplitter.py:806-816)",
    )
    p.add_argument(
        "-P", "--polish-everything", action="store_true", help="polish all contigs, even unseparated"
    )
    p.add_argument("-F", "--force", action="store_true", help="overwrite the output directory")
    p.add_argument("--resume", action="store_true", help="resume a previous run from its artifacts")
    p.add_argument(
        "-u",
        "--rescue_snps",
        type=float,
        default=0.33,
        help="keep all variants with at least this second-allele frequency",
    )
    p.add_argument(
        "--rarest-strain-abundance",
        type=float,
        default=0.01,
        help="abundance of the rarest strain to recover (drives coverage "
        "caps; reference default 0.01, hairsplitter.py:45)",
    )
    p.add_argument(
        "-c", "--haploid-coverage", type=float, default=0.0, help="coverage of one haplotype (ploidy cap)"
    )
    p.add_argument(
        "--correct-assembly",
        action="store_true",
        help="correct assembly errors before splitting (GenomeTailor stage)",
    )
    p.add_argument(
        "-p",
        "--polisher",
        default="racon",
        choices=["racon", "medaka"],
        help="racon: in-process vote+POA consensus ladder; medaka: adds the "
        "pretrained NN base-caller pass after the ladder (models/polisher.py)",
    )
    p.add_argument(
        "-q", "--min-read-quality", type=float, default=0,
        help="filter out reads with average quality below this (fastq only)",
    )
    p.add_argument(
        "-l", "--low-memory", action="store_true",
        help="stream reads in batches; bounded resident sequence cache "
        "(auto-on above 1000x coverage, like the reference)",
    )
    p.add_argument("--no_clean", action="store_true", help="keep temporary files")
    p.add_argument(
        "-d", "--debug", action="store_true",
        help="keep all tmp/ artifacts (implies --no_clean) for debugging",
    )
    p.add_argument(
        "--profile",
        default="",
        metavar="DIR",
        help="capture a torch.profiler chrome trace of the whole run into DIR",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device of the device stages (default cuda; cpu runs the "
        "plain PyTorch versions of the kernels)",
    )
    p.add_argument(
        "--devices",
        type=int,
        default=1,
        help="cards to spread the job over, one process each from --device's card on: "
        "reads sharded for mapping, contigs for stages 3-4, stages 5-6 on the first",
    )
    p.add_argument(
        "--minimap2-params",
        default="",
        help="minimap2-style seeding overrides applied to the BUILT-IN "
        "mapper (no subprocesses here): '-k INT' and '-w INT' are honored, "
        "other tokens are ignored with a notice (reference hairsplitter.py:46)",
    )
    # the reference's external-tool path flags (`hairsplitter.py:47-50`):
    # accepted so existing invocations don't break, ignored because every
    # tool is in-process here
    for legacy in ("--path_to_minigraph", "--path_to_medaka", "--path_to_python", "--path_to_raven"):
        p.add_argument(legacy, default="", help=argparse.SUPPRESS)
    p.add_argument("-v", "--version", action="version", version=__version__)
    return p.parse_args(argv)


def apply_minimap2_params(cfg, params: str):
    """Map minimap2-style '-k INT -w INT' tokens onto MapConfig (both
    '-k15' and '-k 15' forms); returns (cfg, ignored_tokens)."""
    import re
    from dataclasses import replace

    ignored = []
    kw = {}
    toks = params.split()
    i = 0
    while i < len(toks):
        t = toks[i]
        m = re.fullmatch(r"-([kw])(\d+)?", t)
        if m:
            if m.group(2) is not None:
                kw[m.group(1)] = int(m.group(2))
            elif i + 1 < len(toks) and toks[i + 1].isdigit():
                kw[m.group(1)] = int(toks[i + 1])
                i += 1
            i += 1
            continue
        ignored.append(t)
        i += 1
    if kw:
        cfg = replace(cfg, map=replace(cfg.map, **kw))
    return cfg, ignored


def main(argv=None):
    args = parse_args(argv)
    import os

    if os.path.exists(args.output) and os.listdir(args.output) and not (args.force or args.resume):
        print(
            f"ERROR: output directory {args.output} is not empty (use -F to overwrite or --resume)",
            file=sys.stderr,
        )
        return 1
    cfg = PipelineConfig(
        technology=args.technology,
        polish_everything=args.polish_everything,
        polisher=args.polisher,
        dont_simplify=args.dont_simplify,
        auto_frac=args.rescue_snps,
        haploid_coverage=args.haploid_coverage,
        rarest_strain_abundance=args.rarest_strain_abundance,
        resume=args.resume,
        correct_assembly=args.correct_assembly,
        no_clean=args.no_clean,
        min_read_quality=args.min_read_quality,
        low_memory=args.low_memory,
        debug=args.debug,
        threads=args.threads,
        device=args.device,
        devices=args.devices,
    )
    if args.minimap2_params:
        cfg, ignored = apply_minimap2_params(cfg, args.minimap2_params)
        if ignored:
            print(
                f"note: ignoring minimap2 params {' '.join(ignored)} "
                "(mapping is in-process; only -k/-w translate)",
                file=sys.stderr,
            )
    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            run_pipeline(args.assembly, args.fastq, args.output, cfg)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        run_pipeline(args.assembly, args.fastq, args.output, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
