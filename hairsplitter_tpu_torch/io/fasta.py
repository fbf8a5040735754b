"""FASTA/FASTQ I/O with a lazy, byte-offset-indexed read store.

Mirrors the reference's low-memory read handling (`src/input_output.cpp:39-109`:
reads are indexed by file offset at parse time; sequences are loaded on demand
per contig and freed afterwards) — but as a host-side Python/NumPy component of
an in-process engine rather than a C++ binary.

Supports .fa/.fasta/.fq/.fastq, optionally gzip-compressed.

Copy of `hairsplitter_tpu/io/fasta.py`: same functions, names and results; only the
imports point at this package's own modules.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field

import numpy as np


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_fasta(path: str) -> dict[str, str]:
    """Eagerly read a whole FASTA/FASTQ file into {name: sequence}."""
    store = ReadStore(path, lazy=False)
    return {store.names[i]: store.get_seq(i) for i in range(len(store))}


def write_fasta(path: str, seqs: dict[str, str], width: int = 0) -> None:
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            if width and width > 0:
                for i in range(0, len(seq), width):
                    f.write(seq[i : i + width] + "\n")
            else:
                f.write(seq + "\n")


def filter_fastq_by_quality(in_path: str, out_path: str, min_quality: float) -> int:
    """Drop FASTQ reads with mean phred below min_quality (reference
    stage 0.2, `hairsplitter.py:495-513`). Returns the number kept."""
    kept = 0
    with _open_text(in_path) as inf, open(out_path, "w") as outf:
        while True:
            header = inf.readline()
            if not header:
                break
            seq = inf.readline()
            plus = inf.readline()
            qual = inf.readline()
            q = qual.strip()
            if not q:
                break
            avg = sum(ord(c) - 33 for c in q) / len(q)
            if avg >= min_quality:
                outf.write(header + seq + plus + qual)
                kept += 1
    return kept


@dataclass
class ReadStore:
    """Indexed access to the reads of a FASTA/FASTQ file.

    By default sequences are loaded lazily through seek() on demand and can be
    dropped again with :meth:`free`, so only the working set of one contig needs
    to be resident (reference behavior: `src/input_output.cpp:546-569`).
    Gzipped files do not support random access, so they are read eagerly.
    """

    path: str
    lazy: bool = True
    names: list[str] = field(default_factory=list, init=False)
    lengths: np.ndarray = field(default=None, init=False)
    _offsets: list[tuple[int, int]] = field(default_factory=list, init=False)  # (offset, nlines)
    _seqs: dict[int, str] = field(default_factory=dict, init=False)
    _name_to_idx: dict[str, int] = field(default_factory=dict, init=False)

    def __post_init__(self):
        self._gz = self.path.endswith(".gz")
        if self._gz:
            self.lazy = False
        lengths = []
        fastq = None
        with _open_text(self.path) as f:
            pos = f.tell() if not self._gz else 0
            line = f.readline()
            while line:
                if fastq is None:
                    if line.startswith("@"):
                        fastq = True
                    elif line.startswith(">"):
                        fastq = False
                    else:
                        raise ValueError(f"{self.path}: not FASTA/FASTQ (first line {line[:40]!r})")
                name = line[1:].split()[0].strip()
                self._name_to_idx[name] = len(self.names)
                self.names.append(name)
                if fastq:
                    seq_off = f.tell() if not self._gz else -1
                    seq = f.readline().strip()
                    f.readline()  # +
                    f.readline()  # quals
                    self._offsets.append((seq_off, 1))
                    lengths.append(len(seq))
                    if not self.lazy:
                        self._seqs[len(self.names) - 1] = seq
                    pos = f.tell() if not self._gz else 0
                    line = f.readline()
                else:
                    seq_off = f.tell() if not self._gz else -1
                    nchars = 0
                    nlines = 0
                    chunks = [] if not self.lazy else None
                    line = f.readline()
                    while line and not line.startswith(">"):
                        s = line.strip()
                        nchars += len(s)
                        nlines += 1
                        if chunks is not None:
                            chunks.append(s)
                        line = f.readline()
                    self._offsets.append((seq_off, nlines))
                    lengths.append(nchars)
                    if chunks is not None:
                        self._seqs[len(self.names) - 1] = "".join(chunks)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self._fh = None

    def __len__(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        return self._name_to_idx[name]

    def get_seq(self, idx: int) -> str:
        """Sequence of read idx (loads and caches it if lazy)."""
        seq = self._seqs.get(idx)
        if seq is not None:
            return seq
        if self._fh is None:
            self._fh = open(self.path, "r")
        off, nlines = self._offsets[idx]
        self._fh.seek(off)
        seq = "".join(self._fh.readline().strip() for _ in range(nlines))
        self._seqs[idx] = seq
        return seq

    def get_seq_by_name(self, name: str) -> str:
        return self.get_seq(self._name_to_idx[name])

    def free(self, indices=None) -> None:
        """Drop cached sequences (all, or the given indices)."""
        if not self.lazy:
            return
        if indices is None:
            self._seqs.clear()
        else:
            for i in indices:
                self._seqs.pop(i, None)

    def total_bases(self) -> int:
        return int(self.lengths.sum())


class LazyReadSeqs:
    """Dict-like view over a ReadStore with a bounded LRU of decoded
    sequences — the low-memory (-l) read access path. The reference keeps
    only one contig's reads resident (`src/input_output.cpp:546-569`,
    loaded inside an omp critical and freed after,
    `src/call_variants.cpp:1295-1365`); the LRU gives the same flat-memory
    property without per-stage load/free choreography."""

    def __init__(self, store: "ReadStore", cache_size: int = 2048):
        from collections import OrderedDict

        self._store = store
        self._cap = cache_size
        self._lru: "OrderedDict[int, str]" = OrderedDict()

    def __getitem__(self, idx: int) -> str:
        lru = self._lru
        if idx in lru:
            lru.move_to_end(idx)
            return lru[idx]
        seq = self._store.get_seq(idx)
        self._store.free([idx])
        lru[idx] = seq
        if len(lru) > self._cap:
            lru.popitem(last=False)
        return seq

    def get(self, idx: int, default=None):
        try:
            return self[idx]
        except (KeyError, IndexError):
            return default

    def __contains__(self, idx) -> bool:
        return 0 <= idx < len(self._store)

    def __len__(self) -> int:
        return len(self._store)

    def __iter__(self):
        return iter(range(len(self._store)))
