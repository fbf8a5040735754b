"""The CIGAR walk of a job's alignments, one route per device: every
alignment's pileup cells and insertion records (`pipeline/pileup.py:
alignment_cells_full`'s four arrays) and stage 3's dense window blocks
(`build_window_blocks`'), with the blocks' column statistics when asked,
gathered in one job-level `CellStore` that stage 3 and stage 5 both read.

`walk_alignments` takes the card route on a CUDA device: the job's runs,
read codes (each read encoded once), alignment records and block rows go in
one pinned buffer and one copy; one launch of `csrc/pileup_cells.cu` writes
the cells and fills the blocks, the window-stats kernel (`ops/variants.py:
window_stats_packed`) reads the blocks where they lie, and blocks, cells
and statistics come back in one copy. Elsewhere it runs the host copies,
`alignment_cells_full` per alignment and `build_window_blocks` per contig,
and `window_stats_blocks`. Both give the same store, bit for bit.

The host side of the card route is `pack_contig` (per contig: the runs,
the per-alignment counts, the window rows) and `JobPack` (per job: the
offsets of every output, the buffers); `JobPack.unpack` reads the copy
back into the store. The store's arrays are read-only: every alignment's
cells are views of them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import BASE_LUT, encode_seq
from ..io.cigar import OP_I
from ..pipeline.pileup import WindowBlock, alignment_cells_full, build_window_blocks, orient_read
from ._build import launch
from .variants import unpack_window_stats, window_stats_blocks, window_stats_bytes, window_stats_packed

# ASCII -> base code as a bytes.translate table (`constants.encode_seq`'s lookup)
_CODE_TABLE = BASE_LUT.astype(np.uint8).tobytes()

# the fields of an alignment's int64 record (csrc/pileup_cells.cu: A_*)
(A_READ_OFF, A_READ_LEN, A_STRAND, A_Q_START, A_Q_END, A_T_START, A_RUN_OFF, A_N_RUNS, A_N_CELLS, A_TRI_OFF,
 A_INS_OFF, A_CONTIG_LEN, A_WIN_LO, A_WIN_CNT, A_SLOT_OFF) = range(15)
NF = 16


@dataclass
class ContigWalk:
    """One contig's alignments packed for the walk: the arrays that depend
    on nothing but the alignments (per alignment int64 [n], the runs, the
    window rows), made per contig on the host."""

    contig: str
    length: int
    alns: list
    window: int  # 0: no window blocks
    read_idx: np.ndarray
    strand: np.ndarray
    q_start: np.ndarray
    q_end: np.ndarray
    t_start: np.ndarray
    n_cells: np.ndarray  # recorded cells (contig positions t_start, t_start + 1, ...)
    n_ins: np.ndarray  # insertion records
    run_off: np.ndarray  # [n + 1] into ops / lens
    ops: np.ndarray  # int8
    lens: np.ndarray  # int32
    rows: list  # per window block, the alignments it holds (int64), as build_window_blocks lists them
    block_rows: np.ndarray  # per window block its rows, at least 1
    win_lo: np.ndarray  # first window the alignment has a row in
    win_cnt: np.ndarray  # windows it has a row in
    slots: np.ndarray  # its rows, window by window, numbered from the contig's first block row

    @property
    def n_tri(self) -> np.ndarray:
        """Trimers an alignment stores: its cells, but two for one cell."""
        return self.n_cells + (self.n_cells == 1)


def pack_contig(contig: str, length: int, alns: list, window: int) -> ContigWalk:
    """`ContigWalk` of `alns` on a contig of `length`; window 0 asks for no
    window blocks. The rows of window wi are the alignments with t_start <
    min((wi + 1) * window, length) and t_end > wi * window, in list order,
    and an empty window keeps one row (`build_window_blocks`)."""
    n = len(alns)

    def field(name):
        return np.fromiter((getattr(a, name) for a in alns), np.int64, n)

    t_start, t_end = field("t_start"), field("t_end")
    n_runs = np.fromiter((len(a.cigar_ops) for a in alns), np.int64, n)
    run_off = np.zeros(n + 1, np.int64)
    np.cumsum(n_runs, out=run_off[1:])
    if n:
        ops = np.concatenate([np.asarray(a.cigar_ops, np.int8) for a in alns])
        lens = np.concatenate([np.asarray(a.cigar_lens, np.int32) for a in alns])
    else:
        ops, lens = np.zeros(0, np.int8), np.zeros(0, np.int32)
    if lens.size and int(lens.min()) < 0:
        raise ValueError("negative CIGAR run length")
    starts = run_off[:-1][n_runs > 0]  # reduceat over the alignments that have runs
    total = np.zeros(n, np.int64)
    n_ins = np.zeros(n, np.int64)
    if starts.size:
        total[n_runs > 0] = np.add.reduceat(lens, starts, dtype=np.int64)
        n_ins[n_runs > 0] = np.add.reduceat(np.where(ops == OP_I, lens, 0), starts, dtype=np.int64)
    rows: list = []
    block_rows = np.zeros(0, np.int64)
    win_lo = np.zeros(n, np.int64)
    win_cnt = np.zeros(n, np.int64)
    slots = np.zeros(0, np.int64)
    if window:
        n_win = max(1, -(-length // window))
        ws = np.arange(n_win, dtype=np.int64) * window
        we = np.minimum(ws + window, length)
        mask = (t_start[None, :] < we[:, None]) & (t_end[None, :] > ws[:, None])  # [windows, alignments]
        rows = [np.nonzero(m)[0].astype(np.int64) for m in mask]
        block_rows = np.maximum(mask.sum(axis=1), 1).astype(np.int64)
        first_row = np.zeros(n_win, np.int64)
        np.cumsum(block_rows[:-1], out=first_row[1:])
        row_of = first_row[:, None] + np.cumsum(mask, axis=1) - 1
        win_cnt = mask.sum(axis=0).astype(np.int64)
        win_lo = np.where(win_cnt > 0, np.argmax(mask, axis=0), 0).astype(np.int64)
        slots = row_of.T[mask.T].astype(np.int64)  # alignment by alignment, windows rising
    return ContigWalk(
        contig=contig, length=length, alns=alns, window=window, read_idx=field("read_idx"),
        strand=field("strand"), q_start=field("q_start"), q_end=field("q_end"), t_start=t_start,
        n_cells=total - n_ins, n_ins=n_ins, run_off=run_off, ops=ops, lens=lens, rows=rows,
        block_rows=block_rows, win_lo=win_lo, win_cnt=win_cnt, slots=slots,
    )


@dataclass
class CellStore:
    """Every walked alignment's cells, contig by contig in walk order, and
    the contigs' window blocks (and their statistics, if asked)."""

    walks: list  # ContigWalk per contig
    first: list  # index of each contig's first alignment in the tables
    t_start: np.ndarray  # int64 [n]
    n_cells: np.ndarray  # int64 [n]
    tri_off: np.ndarray  # int64 [n + 1] into tri / central
    ins_off: np.ndarray  # int64 [n + 1] into ins_t / ins_c
    tri: np.ndarray  # int8
    central: np.ndarray  # int8, tri // 25
    ins_t: np.ndarray  # int64
    ins_c: np.ndarray  # int8
    blocks: list  # per contig its WindowBlocks (empty without window)
    stats: tuple | None = None  # window_stats_blocks' five arrays over every block, contigs in order
    positions: np.ndarray | None = None  # arange over every cell position: each tpos is a view of it

    def __post_init__(self):
        top = int((self.t_start + self.n_cells).max(initial=0))
        self.positions = np.arange(top, dtype=np.int64)
        for a in (self.positions, self.tri, self.central, self.ins_t, self.ins_c):
            a.flags.writeable = False  # shared by every alignment's views

    def find(self, contig: str, alns: list) -> int | None:
        """The walk of `contig` if it walked this very alignment list."""
        for i, w in enumerate(self.walks):
            if w.contig == contig and w.alns is alns:
                return i
        return None

    def cells(self, i: int, central: bool = False) -> list:
        """Walk i's alignments' (tpos, trimer, insertion positions,
        insertion bases), as `alignment_cells_full` returns them; with
        `central`, the central bases (trimer // 25) in the trimers' place."""
        w, a0 = self.walks[i], self.first[i]
        n = len(w.alns)
        vals = self.central if central else self.tri
        to = self.tri_off[a0 : a0 + n + 1].tolist()
        io = self.ins_off[a0 : a0 + n + 1].tolist()
        ts, nc = self.t_start[a0 : a0 + n].tolist(), self.n_cells[a0 : a0 + n].tolist()
        pos = self.positions
        return [
            (pos[ts[k] : ts[k] + nc[k]] if ts[k] >= 0 else np.arange(ts[k], ts[k] + nc[k], dtype=np.int64),
             vals[to[k] : to[k + 1]], self.ins_t[io[k] : io[k + 1]], self.ins_c[io[k] : io[k + 1]])
            for k in range(n)
        ]


def _offsets(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=out[1:])
    return out


def _cat(arrays: list, dtype) -> np.ndarray:
    return np.concatenate(arrays).astype(dtype, copy=False) if arrays else np.zeros(0, dtype)


def _store(walks: list, tri, central, ins_t, ins_c, blocks, stats) -> CellStore:
    first = _offsets(np.array([len(w.alns) for w in walks], np.int64))[:-1].tolist()
    return CellStore(
        walks=walks, first=first,
        t_start=_cat([w.t_start for w in walks], np.int64), n_cells=_cat([w.n_cells for w in walks], np.int64),
        tri_off=_offsets(_cat([w.n_tri for w in walks], np.int64)),
        ins_off=_offsets(_cat([w.n_ins for w in walks], np.int64)),
        tri=tri, central=central, ins_t=ins_t, ins_c=ins_c, blocks=blocks, stats=stats,
    )


def _walk_host(walks: list, read_seqs, device, codes_ws) -> CellStore:
    """The host copies: `alignment_cells_full` per alignment, then
    `build_window_blocks` per contig, then `window_stats_blocks`."""
    tris, inst, insc, blocks = [], [], [], []
    for w in walks:
        oriented = [orient_read(encode_seq(read_seqs[a.read_idx]), a.strand) for a in w.alns]
        for a, oc in zip(w.alns, oriented):
            _, tri, it, ic = alignment_cells_full(a, oc)
            tris.append(tri)
            inst.append(it)
            insc.append(ic)
        blocks.append(build_window_blocks(w.length, w.alns, oriented, w.window) if w.window else [])
    tri = _cat(tris, np.int8)
    stats = None
    if codes_ws is not None:
        stats = window_stats_blocks([b.tri for bl in blocks for b in bl], codes_ws, device)
    central = (tri.astype(np.int16) // 25).astype(np.int8)
    return _store(walks, tri, central, _cat(inst, np.int64), _cat(insc, np.int8), blocks, stats)


def _encode_reads(walks: list, read_seqs):
    """The distinct reads of the walks as bytes, and each alignment's read
    number among them."""
    ridx = _cat([w.read_idx for w in walks], np.int64)
    uniq, inv = np.unique(ridx, return_inverse=True)
    raw = []
    for r in uniq.tolist():
        s = read_seqs[r]
        raw.append(s.encode() if isinstance(s, str) else bytes(s))
    return raw, inv


def _align(n: int) -> int:
    return (n + 15) // 16 * 16


class JobPack:
    """One job's walk packed for the kernel: the input buffer (uint8,
    pinned if asked) and where each part of the input and of the output
    buffer lies."""

    IN = ("alns", "slots", "block_off", "lens", "ops", "codes", "codes_w")
    OUT = ("stats", "err", "ins_t", "blocks", "tri", "central", "ins_c")

    def __init__(self, walks: list, read_seqs, codes_ws=None, pin: bool = False):
        self.walks = walks
        windows = {w.window for w in walks if w.window}
        if len(windows) > 1:
            raise ValueError(f"one window size a job, got {sorted(windows)}")
        self.window = windows.pop() if windows else 0
        self.with_stats = codes_ws is not None
        n_alns = np.array([len(w.alns) for w in walks], np.int64)
        n = int(n_alns.sum())
        raw, inv = _encode_reads(walks, read_seqs)
        read_len = np.fromiter((len(b) for b in raw), np.int64, len(raw))
        read_off = _offsets(read_len)
        n_cells = _cat([w.n_cells for w in walks], np.int64)
        n_ins = _cat([w.n_ins for w in walks], np.int64)
        a_len = read_len[inv] if n else np.zeros(0, np.int64)
        if ((a_len == 0) & (n_cells + n_ins > 0)).any():
            raise IndexError("an alignment's read is empty")
        if (n_cells == 0).any():  # as numpy's broadcast of no cell against the (0, 1) seeds
            raise ValueError("operands could not be broadcast together with shapes (0,) (2,) ")
        if n and int((n_cells + n_ins).max()) >= 1 << 31:
            raise ValueError("the kernel takes alignments of fewer than 2**31 cells and insertions")
        n_tri = n_cells + (n_cells == 1)
        self.n_blocks = int(sum(w.block_rows.size for w in walks))
        block_rows = _cat([w.block_rows for w in walks], np.int64)
        block_off = _offsets(block_rows)
        self.rows = int(block_off[-1])
        contig_row0 = np.repeat(_offsets(np.array([int(w.block_rows.sum()) for w in walks], np.int64))[:-1],
                                [w.slots.size for w in walks]) if walks else np.zeros(0, np.int64)
        slots = _cat([w.slots for w in walks], np.int64) + contig_row0
        ops = _cat([w.ops for w in walks], np.int8)
        lens = _cat([w.lens for w in walks], np.int32)
        run_base = np.repeat(_offsets(np.array([w.ops.size for w in walks], np.int64))[:-1], n_alns)
        self.tri_off, self.ins_off = _offsets(n_tri), _offsets(n_ins)
        self.n_tri, self.n_ins = int(self.tri_off[-1]), int(self.ins_off[-1])
        if self.with_stats and len(codes_ws) != self.n_blocks:
            raise ValueError(f"{len(codes_ws)} contig code rows for {self.n_blocks} window blocks")
        P = self.window

        sizes = {
            "alns": 8 * NF * n, "slots": 8 * slots.size, "block_off": 8 * block_off.size, "lens": 4 * lens.size,
            "ops": ops.size, "codes": int(read_off[-1]), "codes_w": self.n_blocks * P if self.with_stats else 0,
        }
        self.at, size = {}, 0
        for name in self.IN:
            self.at[name] = size
            size += _align(sizes[name])
        self.in_bytes = size
        self.staging = torch.empty(max(1, size), dtype=torch.uint8, pin_memory=pin)
        host = self.staging.numpy()

        def part(name, dtype, count):
            return host[self.at[name] : self.at[name] + np.dtype(dtype).itemsize * count].view(dtype)

        rec = part("alns", np.int64, n * NF).reshape(n, NF)
        rec[:] = 0
        cols = {
            A_READ_OFF: read_off[:-1][inv] if n else 0, A_READ_LEN: a_len,
            A_STRAND: _cat([w.strand for w in walks], np.int64), A_Q_START: _cat([w.q_start for w in walks], np.int64),
            A_Q_END: _cat([w.q_end for w in walks], np.int64), A_T_START: _cat([w.t_start for w in walks], np.int64),
            A_RUN_OFF: _cat([w.run_off[:-1] for w in walks], np.int64) + run_base,
            A_N_RUNS: _cat([np.diff(w.run_off) for w in walks], np.int64), A_N_CELLS: n_cells,
            A_TRI_OFF: self.tri_off[:-1], A_INS_OFF: self.ins_off[:-1],
            A_CONTIG_LEN: np.repeat(np.array([w.length for w in walks], np.int64), n_alns),
            A_WIN_LO: _cat([w.win_lo for w in walks], np.int64), A_WIN_CNT: _cat([w.win_cnt for w in walks], np.int64),
            A_SLOT_OFF: _offsets(_cat([w.win_cnt for w in walks], np.int64))[:-1],
        }
        for col, values in cols.items():
            rec[:, col] = values
        part("slots", np.int64, slots.size)[:] = slots
        part("block_off", np.int64, block_off.size)[:] = block_off
        part("lens", np.int32, lens.size)[:] = lens
        part("ops", np.int8, ops.size)[:] = ops
        part("codes", np.int8, int(read_off[-1]))[:] = np.frombuffer(b"".join(raw).translate(_CODE_TABLE), np.int8)
        if self.with_stats and self.n_blocks:
            np.stack(codes_ws, out=part("codes_w", np.int8, self.n_blocks * P).reshape(self.n_blocks, P))

        sizes = {
            "stats": window_stats_bytes(self.n_blocks, P) if self.with_stats else 0, "err": 8,
            "ins_t": 8 * self.n_ins, "blocks": self.rows * P, "tri": self.n_tri, "central": self.n_tri,
            "ins_c": self.n_ins,
        }
        self.out_at, size = {}, 0
        for name in self.OUT:
            self.out_at[name] = size
            size += _align(sizes[name])
        self.out_bytes = size
        self.n_alns = n

    def kernel_args(self, in_ptr: int, out_ptr: int) -> tuple:
        """`hs_pileup_cells`' arguments before its stream, for an input and
        an output buffer at these addresses."""
        i, o = self.at, self.out_at
        return (
            in_ptr + i["alns"], self.n_alns, in_ptr + i["ops"], in_ptr + i["lens"], in_ptr + i["codes"],
            in_ptr + i["slots"], self.window, out_ptr + o["blocks"], self.rows * self.window, out_ptr + o["tri"],
            out_ptr + o["central"], out_ptr + o["ins_t"], out_ptr + o["ins_c"], out_ptr + o["err"],
        )

    def window_stats(self, inb: torch.Tensor, out: torch.Tensor) -> None:
        """The blocks' statistics, from the blocks in `out` into its stats
        part, on the buffers' device (`window_stats_packed`)."""
        if not self.with_stats or self.n_blocks == 0:
            return
        nb, P = self.n_blocks, self.window
        flat = out[self.out_at["blocks"] : self.out_at["blocks"] + self.rows * P].view(torch.int8).view(self.rows, P)
        offsets = inb[self.at["block_off"] : self.at["block_off"] + 8 * (nb + 1)].view(torch.int64)
        codes_w = inb[self.at["codes_w"] : self.at["codes_w"] + nb * P].view(torch.int8).view(nb, P)
        s0 = self.out_at["stats"]
        window_stats_packed(flat, offsets, codes_w, out=out[s0 : s0 + window_stats_bytes(nb, P)])

    def unpack(self, buf: np.ndarray) -> CellStore:
        """The store from the output buffer (uint8 numpy), whose arrays are
        views of it. Raises IndexError where an insertion reads past its
        read, as numpy's indexing does."""
        o, P = self.out_at, self.window

        def part(name, dtype, count):
            return buf[o[name] : o[name] + np.dtype(dtype).itemsize * count].view(dtype)

        err = int(part("err", np.uint64, 1)[0])
        if err != (1 << 64) - 1:
            raise IndexError(f"an insertion of alignment {err} of the job reads past its read")
        stats = None
        if self.with_stats:
            stats = tuple(x.numpy() for x in unpack_window_stats(
                torch.from_numpy(part("stats", np.uint8, window_stats_bytes(self.n_blocks, P))), self.n_blocks, P))
        flat = part("blocks", np.int8, self.rows * P).reshape(self.rows, P) if P else None
        blocks, row = [], 0
        for w in self.walks:
            bl = []
            contig = w.alns[0].contig if w.alns else ""
            for wi, nr in enumerate(w.block_rows.tolist()):
                start = wi * P
                bl.append(WindowBlock(contig=contig, start=start, length=min(start + P, w.length) - start,
                                      rows=w.rows[wi], tri=flat[row : row + nr]))
                row += nr
            blocks.append(bl)
        return _store(self.walks, part("tri", np.int8, self.n_tri), part("central", np.int8, self.n_tri),
                      part("ins_t", np.int64, self.n_ins), part("ins_c", np.int8, self.n_ins), blocks, stats)


def _walk_card(walks: list, read_seqs, device, codes_ws) -> CellStore:
    """One pinned copy in, one launch of the walk, the statistics on the
    blocks where they lie, one copy back."""
    pk = JobPack(walks, read_seqs, codes_ws, pin=True)
    inb = pk.staging.to(device, non_blocking=True)
    out = torch.empty(max(1, pk.out_bytes), dtype=torch.uint8, device=device)
    launch("pileup_cells", out.device, *pk.kernel_args(inb.data_ptr(), out.data_ptr()))
    pk.window_stats(inb, out)
    back = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
    back.copy_(out, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return pk.unpack(back.numpy())


def walk_alignments(walks: list, read_seqs, device, codes_ws: list | None = None) -> CellStore:
    """The cells of every alignment of `walks` (and their window blocks),
    on `device`: the card route on CUDA, the host copies elsewhere. With
    `codes_ws` (int8 [window] contig codes, one per window block, contigs
    in order) the store also holds the blocks' statistics."""
    device = torch.device(device)
    if device.type == "cuda":
        return _walk_card(walks, read_seqs, device, codes_ws)
    return _walk_host(walks, read_seqs, device, codes_ws)
