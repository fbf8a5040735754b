"""GAF (graph alignment) parsing — the untangler's read-path input.

Mirrors the reference's `read_GAF_parallel` filter
(`src/GraphUnzip/input_output.py:120-140`): keep records whose path visits
more than one contig; optional identity (`id:f:` tag) and whole-read mapping
fraction thresholds — HairSplitter's own invocation passes (0, 0), i.e. no
extra filtering (`src/GraphUnzip/simple_unzip.py:826`).

Copy of `hairsplitter_tpu/io/gaf.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

import re

_STEP = re.compile(r"([><])([^><\s]+)")


def parse_gaf_path(path_str: str) -> list[tuple[str, int]]:
    """'>a<b' -> [(a, 1), (b, 0)] (1 = forward, 0 = reverse)."""
    return [(m.group(2), 1 if m.group(1) == ">" else 0) for m in _STEP.finditer(path_str)]


def parse_gaf(
    path: str,
    similarity_threshold: float = 0.0,
    whole_mapping_threshold: float = 0.0,
    min_contigs: int = 2,
) -> tuple[dict[int, list[tuple[str, int]]], list[str]]:
    """Returns ({row: [(contig, orient)]}, [read name per row])."""
    read_paths: dict[int, list[tuple[str, int]]] = {}
    names: list[str] = []
    with open(path) as f:
        for line in f:
            ls = line.rstrip("\n").split("\t")
            if len(ls) < 6:
                continue
            steps = parse_gaf_path(ls[5])
            if len(steps) < min_contigs:
                continue
            if similarity_threshold > 0:
                idtags = [t for t in ls[6:] if t.startswith("id:f:")]
                if idtags and float(idtags[-1].split(":")[-1]) <= similarity_threshold:
                    continue
            if whole_mapping_threshold > 0:
                try:
                    if (float(ls[3]) - float(ls[2])) / float(ls[1]) <= whole_mapping_threshold:
                        continue
                except (ValueError, ZeroDivisionError):
                    continue
            read_paths[len(names)] = steps
            names.append(ls[0])
    return read_paths, names
