#!/usr/bin/env python3
"""Two processes of the distributed entry point that both find no built
kernel library: each builds the CUDA kernels at first use, at the same time,
into the one build directory (`hairsplitter_tpu_torch/ops/_build.py`
publishes a finished library with an atomic rename).

Run from the root of a checkout on a machine with a GPU and nvcc:

    python scripts/torch_two_process_cold_build.py

It empties `hairsplitter_tpu_torch/build/`, simulates a 12 kb two-contig,
two-strain dataset, starts both processes on cuda:0, and checks that both
exit with 0, that each launched the fused Myers kernel, and that the build
directory ends with exactly one kernel library and no leftover work
directory. Prints one summary line; exits non-zero on any failure."""

from __future__ import annotations

import glob
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    from hairsplitter_tpu_torch.ops import _build
    from hairsplitter_tpu_torch.utils import sim

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    with tempfile.TemporaryDirectory(prefix="hs_cold_") as root:
        rng = np.random.default_rng(3)
        asm, reads = os.path.join(root, "asm.fa"), os.path.join(root, "reads.fa")
        with open(asm, "w") as fa, open(reads, "w") as fr:
            for c in range(2):
                haps = sim.make_haplotypes(6000, 2, 0.03, rng)
                fa.write(f">chr{c}\n{haps[0]}\n")
                sr = sim.simulate_reads(haps, coverage=14, read_len=1600, rng=rng,
                                        sub_rate=0.02, ins_rate=0.01, del_rate=0.01, len_sd=200)
                for name, seq in zip(sr.names, sr.seqs):
                    fr.write(f">c{c}_{name}\n{seq}\n")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out = os.path.join(root, "out")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "hairsplitter_tpu_torch.parallel.distributed",
                 "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(rank),
                 "-i", asm, "-f", reads, "-o", out],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in range(2)
        ]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=600)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        wall = time.perf_counter() - t0
        for rank, (proc, text) in enumerate(zip(procs, outs)):
            if proc.returncode != 0:
                print(f"process {rank} exited with {proc.returncode}:\n{text[-3000:]}", file=sys.stderr)
                return 1
        launches = []
        for rank in range(2):
            with open(os.path.join(out, f"hairsplitter.p{rank}.log")) as f:
                launches.append(int(re.findall(r"kernel launches: myers_fused=(\d+)", f.read())[-1]))
        if not os.path.getsize(os.path.join(out, "hairsplitter_final_assembly.gfa")):
            print("empty final assembly", file=sys.stderr)
            return 1
    libs = glob.glob(os.path.join(_build.BUILD_DIR, "libhs_kernels_*.so"))
    left = [n for n in os.listdir(_build.BUILD_DIR) if not n.endswith(".so")]
    ok = len(libs) == 1 and not left and min(launches) > 0
    print(f"two processes from an empty build directory: {wall:.1f} s, K1 fused launches {launches}, "
          f"kernel libraries {[os.path.basename(p) for p in libs]}, leftovers {left}: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
