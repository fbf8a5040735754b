#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`hairsplitter_tpu_torch`) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (each prints its result; any failure raises and exits non-zero):
  1. environment: a CUDA device is required; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the CUDA kernels from `hairsplitter_tpu_torch/csrc/`
     with nvcc for sm_90a (one nvcc per source, in parallel), and the native
     host library with g++;
  3. kernels vs plain versions, on 8,192 seeded random jobs at the main
     path's shape (B = 256, W = 128, edge cases included): K1, the Myers
     kernel, must equal `myers_rows_torch` in its four word streams, and K2,
     the int32 banded-DP kernel, must equal `banded_align_batch_torch` in
     all four outputs in both modes (uint8 bp, int16 enc), bit for bit; all
     are timed with CUDA events. At 32,768 jobs the fused mapping call with
     K2 (kernel="pallas") must equal the call with K1 byte for byte, and
     both calls' parts are timed;
  4. main path, K1: builds the 300 kb x 3-strain, 30x, 10%-error dataset
     (seed 7) and runs the port's CLI on cuda; K1's launch counter must be
     > 0, the final GFA must exist and every strain's recovery must be
     >= 0.95;
  5. main path, K2: the same dataset through `run_pipeline` with
     `PipelineConfig(map=MapConfig(use_myers=False))` on cuda; K2's launch
     counter must be > 0 and K1's must not move during stage 2, the mapping
     that `PipelineConfig.map` configures (the stage-5 and stage-6 remaps
     map with the default MapConfig, K1, in the JAX package too); the SAM
     and the final GFA must be byte-identical to phase 4's and every
     strain's recovery must be >= 0.95;
then prints the kernel table as one JSON line, the card line, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B = 256  # main-path chunk (BandSpec.chunk)
N_CHECK = 8192  # jobs of the kernel-vs-plain check
N_FUSED = 32768  # jobs of the fused-call timing (~ stage 2 of the smoke dataset)
MIN_RECOVERY = 0.95


def random_jobs(rng: np.random.Generator, n: int, spec):
    """Seeded mapping-like jobs: noisy target copies of random queries, with
    empty queries, full-length queries, targets far shorter than the query
    and all-sentinel rows mixed in."""
    from hairsplitter_tpu_torch.ops.align import Q_SENTINEL, T_SENTINEL

    B, T = spec.chunk, spec.t_width
    q = np.full((n, B), Q_SENTINEL, np.int8)
    t = np.full((n, T), T_SENTINEL, np.int8)
    qlens = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    for i in range(n):
        kind = i % 8
        if kind == 7:  # all-sentinel row
            continue
        ql = 0 if kind == 0 else B if kind == 1 else int(rng.integers(1, B + 1))
        base = rng.integers(0, 4, ql).astype(np.int8)
        if kind == 2:  # target much shorter than the query
            tl = max(0, ql - 64 - int(rng.integers(1, 64)))
            ts = base[:tl].copy()
        elif kind == 3:  # unrelated target
            tl = int(rng.integers(0, T + 1))
            ts = rng.integers(0, 4, tl).astype(np.int8)
        else:  # noisy copy with indels
            keep = rng.random(ql) > 0.05
            ts = base[keep]
            ins = rng.random(ts.size) < 0.05
            ts = np.insert(ts, np.nonzero(ins)[0], rng.integers(0, 4, int(ins.sum())).astype(np.int8))
            sub = rng.random(ts.size) < 0.06
            ts[sub] = rng.integers(0, 4, int(sub.sum()))
            ts = ts[:T]
            tl = ts.size
        q[i, :ql] = base
        t[i, :tl] = ts[:tl]
        qlens[i], tlens[i] = ql, tl
    return q, qlens, t, tlens


def build_dataset(root: str):
    """The smoke dataset (`scripts/bench_pipeline.py:build_dataset` defaults):
    300 kb x 3 strains at 1% divergence, 30x of 8 kb reads, 10% error
    (60% substitutions), seed 7; the assembly is the first strain.
    Returns (assembly path, reads path, haplotypes, reads)."""
    from hairsplitter_tpu.io.fasta import write_fasta
    from hairsplitter_tpu.utils import sim

    rng = np.random.default_rng(7)
    haps = sim.make_haplotypes(300_000, 3, 0.01, rng)
    reads = sim.simulate_reads(
        haps, coverage=30.0 / 3, read_len=8000, rng=rng,
        sub_rate=0.06, ins_rate=0.02, del_rate=0.02,
    )
    asm_path = os.path.join(root, "assembly.fasta")
    reads_path = os.path.join(root, "reads.fasta")
    write_fasta(asm_path, {"asm": haps[0]})
    sim.write_sim_fasta(reads_path, reads)
    return asm_path, reads_path, haps, reads


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    # ---- 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda}; card: {card}", flush=True)

    import hairsplitter_tpu_torch  # noqa: F401  (sets full-precision f32 matmuls)
    from hairsplitter_tpu import native
    from hairsplitter_tpu_torch.ops import _build
    from hairsplitter_tpu_torch.ops.align import BandSpec
    from hairsplitter_tpu_torch.ops import align_dp_cuda as ad
    from hairsplitter_tpu_torch.ops import align_myers_cuda as am
    from hairsplitter_tpu_torch.ops.align_device import align_traceback_rows, readout_device, traceback_scan

    # ---- 2. build
    _build.build(force=True)  # always from the checkout's sources
    _build.load_kernels()
    print(f"[build] nvcc sm_90a: {_build.build_info['seconds']:.2f} s "
          f"(cached={_build.build_info['cached']}) -> {_build.build_info['path']}", flush=True)
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    t0 = time.perf_counter()
    native_built = not os.path.exists(os.path.join(native._native_dir(), "libhs_native.so"))
    assert native.get_lib() is not None, "native host library (native/Makefile, g++) did not build"
    print(f"[build] native host library (g++, built now: {native_built}): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernels vs plain versions
    dev = torch.device("cuda")
    spec = BandSpec(chunk=B, band=128)
    rng = np.random.default_rng(0)
    q, qlens, t, tlens = random_jobs(rng, N_CHECK, spec)
    qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    qld, tld = torch.from_numpy(qlens).to(dev), torch.from_numpy(tlens).to(dev)
    got = am.myers_rows(qd, td, spec, emit_tb=True)
    ref = am.myers_rows_torch(qd, td, spec, emit_tb=True)
    torch.cuda.synchronize()
    max_err = 0
    for name, a, b in zip(("P", "M", "nonleft", "isup"), got, ref):
        assert a.shape == (N_CHECK, B, 4) and b.shape == a.shape
        diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
        max_err = max(max_err, diff)
        assert torch.equal(a, b), f"K1 stream {name} differs from the plain version"
    k_ms = cuda_ms(lambda: am.myers_rows(qd, td, spec, emit_tb=True), 50)
    p_ms = cuda_ms(lambda: am.myers_rows_torch(qd, td, spec, emit_tb=True), 3)
    print(f"[kernel] myers_rows == myers_rows_torch on {N_CHECK} jobs x B={B} (4 streams, bit for bit); "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms", flush=True)

    k2_err = 0
    k2_ms, k2_plain_ms = {}, {}
    for emit_enc in (False, True):
        got = ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=emit_enc)
        ref = ad.banded_align_batch_torch(qd, qld, td, tld, spec, emit_enc=emit_enc)
        torch.cuda.synchronize()
        assert got.keys() == ref.keys()
        for key in ref:
            a, b = got[key], ref[key]
            assert a.dtype == b.dtype and a.shape == b.shape, f"K2 {key}: {a.dtype}{tuple(a.shape)}"
            k2_err = max(k2_err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
            assert torch.equal(a, b), f"K2 output {key} (emit_enc={emit_enc}) differs from the plain version"
        mode = "enc" if emit_enc else "bp"
        k2_ms[mode] = cuda_ms(lambda: ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=emit_enc), 20)
        k2_plain_ms[mode] = cuda_ms(lambda: ad.banded_align_batch_torch(qd, qld, td, tld, spec, emit_enc=emit_enc), 3)
        del got, ref
    print(f"[kernel K2] banded_align_batch_dp == banded_align_batch_torch on {N_CHECK} jobs x B={B} "
          f"(bp, enc, row_at_q, colmin_val, colmin_i; bit for bit); "
          + ", ".join(f"{m}: kernel {k2_ms[m]:.4f} ms, plain {k2_plain_ms[m]:.2f} ms" for m in k2_ms),
          flush=True)

    # the fused mapping call's parts at ~stage-2 size
    q, qlens, t, tlens = random_jobs(np.random.default_rng(1), N_FUSED, spec)
    qd, td = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    qld, tld = torch.from_numpy(qlens).to(dev), torch.from_numpy(tlens).to(dev)
    modes = (torch.arange(N_FUSED, device=dev) % 2).to(torch.int32)
    res, nl, up = am.myers_traceback_device(qd, td, qld, tld, spec)
    cost, si, sb, clip = readout_device(res, qld, tld, modes, spec)
    parts = {
        "kernel": cuda_ms(lambda: am.myers_rows(qd, td, spec, emit_tb=True), 10),
        "word_readout": cuda_ms(lambda: am.myers_traceback_device(qd, td, qld, tld, spec), 5),
        "traceback_scan_words": cuda_ms(lambda: am.traceback_scan_words(nl, up, si, sb), 3),
    }
    parts["word_readout"] -= parts["kernel"]
    del res, nl, up
    fused_k1 = align_traceback_rows(qd, qld, td, tld, modes, spec, "myers")
    fused_k2 = align_traceback_rows(qd, qld, td, tld, modes, spec, "pallas")
    assert torch.equal(fused_k2, fused_k1), "the fused buffer with K2 differs from the buffer with K1"
    del fused_k1, fused_k2
    parts["fused_call"] = cuda_ms(lambda: align_traceback_rows(qd, qld, td, tld, modes, spec, "myers"), 3)
    print("[fused] K2 buffer == K1 buffer on %d jobs (byte for byte)" % N_FUSED, flush=True)
    print("[fused] K1 parts at %d jobs: %s" % (
        N_FUSED, ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())), flush=True)
    res = ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=True)
    cost, si, sb, clip = readout_device(res, qld, tld, modes, spec)
    k2_parts = {
        "kernel": cuda_ms(lambda: ad.banded_align_batch_dp(qd, qld, td, tld, spec, emit_enc=True), 10),
        "readout": cuda_ms(lambda: readout_device(res, qld, tld, modes, spec), 5),
        "traceback_scan": cuda_ms(lambda: traceback_scan(res["enc"], si, sb), 3),
        "fused_call": cuda_ms(lambda: align_traceback_rows(qd, qld, td, tld, modes, spec, "pallas"), 3),
        "plain_dp": cuda_ms(lambda: ad.banded_align_batch_torch(qd, qld, td, tld, spec, emit_enc=True), 2),
    }
    enc_bytes = res["enc"].numel() * res["enc"].element_size()
    print("[fused] K2 parts at %d jobs: %s; enc plane %.3f GB, %.3f TB/s (%.1f%% of 3.35 TB/s)" % (
        N_FUSED, ", ".join(f"{k} {v:.3f} ms" for k, v in k2_parts.items()),
        enc_bytes / 1e9, enc_bytes / k2_parts["kernel"] / 1e9,
        100 * enc_bytes / k2_parts["kernel"] / 1e9 / 3.35), flush=True)
    del res, cost, si, sb, clip

    # ---- 4. main path through the CLI
    from hairsplitter_tpu.io.gfa import parse_gfa
    from hairsplitter_tpu.utils.evaluate import evaluate_phasing
    from hairsplitter_tpu_torch import cli
    from hairsplitter_tpu_torch.core.mapping import MapConfig
    from hairsplitter_tpu_torch.pipeline import orchestrate

    def check_run(out, wall, label):
        """Final GFA present, strain recovery >= MIN_RECOVERY; prints the
        stage table. Returns the recovery list."""
        final = os.path.join(out, "hairsplitter_final_assembly.gfa")
        assert os.path.exists(final), f"{label}: no final GFA"
        g = parse_gfa(final)
        assert g.segments and all(len(s) > 0 for s in g.segments.values())
        ev = evaluate_phasing(g.segments, haps)
        recovery = [float(r) for r in ev.haplotype_recovery]
        stats = json.load(open(os.path.join(out, "stage_stats.json")))
        print(f"[{label}] {wall:.1f} s wall, {len(g.segments)} contigs, "
              f"recovery {recovery}, switch errors {ev.total_switch_errors}", flush=True)
        for stage, entry in stats.items():
            extra = ", ".join(f"{k}={v}" for k, v in entry.items() if k != "seconds")
            print(f"[{label}]   {stage:20s} {entry['seconds']:8.3f} s  {extra}")
        assert min(recovery) >= MIN_RECOVERY, f"{label}: strain recovery {recovery} < {MIN_RECOVERY}"
        return recovery

    with tempfile.TemporaryDirectory(prefix="hs_smoke_") as root:
        t0 = time.perf_counter()
        asm_path, reads_path, haps, reads = build_dataset(root)
        print(f"[data] 300 kb x 3 strains, 30x, 10% error, seed 7: {len(reads.seqs)} reads, "
              f"{sum(map(len, reads.seqs)) / 1e3:.0f} read-kbp ({time.perf_counter() - t0:.1f} s)",
              flush=True)

        out = os.path.join(root, "out")
        am.myers_rows.launches = 0
        ad.banded_align_batch_dp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["-i", asm_path, "-f", reads_path, "-o", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = am.myers_rows.launches
        assert rc == 0, f"CLI returned {rc}"
        assert launches > 0, "the main path never launched the Myers kernel"
        print(f"[main] CLI on cuda: K1 launches {launches}, K2 launches "
              f"{ad.banded_align_batch_dp.launches}", flush=True)
        check_run(out, wall, "main")

        # ---- 5. main path with MapConfig(use_myers=False): stage 2 on K2
        out_k2 = os.path.join(root, "out_k2")
        stage2 = {"k1": 0, "k2": 0}
        stage2_map_reads = orchestrate.map_reads

        def counted_map_reads(*args, **kwargs):
            k1, k2 = am.myers_rows.launches, ad.banded_align_batch_dp.launches
            alns = stage2_map_reads(*args, **kwargs)
            stage2["k1"] += am.myers_rows.launches - k1
            stage2["k2"] += ad.banded_align_batch_dp.launches - k2
            return alns

        orchestrate.map_reads = counted_map_reads  # the stage-2 call site
        try:
            am.myers_rows.launches = 0
            ad.banded_align_batch_dp.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orchestrate.run_pipeline(
                asm_path, reads_path, out_k2,
                orchestrate.PipelineConfig(map=MapConfig(use_myers=False)),
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            orchestrate.map_reads = stage2_map_reads
        k2_launches = ad.banded_align_batch_dp.launches
        k1_later = am.myers_rows.launches
        print(f"[main K2] run_pipeline(map=MapConfig(use_myers=False)) on cuda: K2 launches "
              f"{k2_launches} (stage 2: {stage2['k2']}), K1 launches in stage 2 {stage2['k1']}, "
              f"K1 launches of the stage-5/6 remaps (default MapConfig) {k1_later - stage2['k1']}",
              flush=True)
        assert k2_launches > 0 and stage2["k2"] > 0, "the use_myers=False path never launched K2"
        assert stage2["k1"] == 0, "K1 launched during the use_myers=False stage-2 mapping"
        for name in ("tmp/reads_on_asm.sam", "hairsplitter_final_assembly.gfa"):
            with open(os.path.join(out, name), "rb") as f1, open(os.path.join(out_k2, name), "rb") as f2:
                assert f1.read() == f2.read(), f"{name} of the K2 run differs from the K1 run's"
        print("[main K2] tmp/reads_on_asm.sam and hairsplitter_final_assembly.gfa byte-identical "
              "to the K1 run's", flush=True)
        check_run(out_k2, wall, "main K2")

    print(json.dumps({"kernels": [{
        "name": "myers_rows",
        "route": "cuda",
        "source": "hairsplitter_tpu_torch/csrc/myers_rows.cu",
        "replaces": "hairsplitter_tpu/ops/align_myers_pallas.py:50",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "banded_dp",
        "route": "cuda",
        "source": "hairsplitter_tpu_torch/csrc/banded_dp.cu",
        "replaces": "hairsplitter_tpu/ops/align_pallas.py:50",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms["enc"],
        "plain_ms": k2_plain_ms["enc"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
