"""What the fused Myers kernel's time is made of, on one GPU.

Builds `hairsplitter_tpu_torch/csrc/myers_fused.cu` as it is and in a few
edited copies (text substitutions in a temporary directory; the checkout is
not touched), and times each with CUDA events at 8,192 and 32,768 jobs of
`chip_smoke.py:random_jobs` (B = 256), for two kinds of input and two mode
patterns:
  rand   the jobs as drawn: query lengths from 0 to B within one warp;
  fullq  the same codes with every q_len = B, so every lane steps every row;
  alt / glo   alternating global / extension modes, or all global.
Variants:
  base              the kernel as committed;
  no_walk           forward pass only (the walk's loop bound set to -1);
  no_walk_no_store  forward pass with the scratch stores made unreachable;
  split_scratch     nonleft and isup words in two [B, N, 4] halves of the
                    scratch, 16 B per lane and row in each (half a sector),
                    instead of one 32-byte sector per lane and row;
  ahead4, ahead16   the walk loading 4 or 16 rows at once instead of 8;
  aln64, aln128     blocks of 2 or 4 warps instead of one.
Differences between variants in one call are meaningful; the edited copies
compute wrong or no tokens and are never used for anything else. Then
prints, from `cuobjdump -sass` of the committed kernel, the number of
machine instructions between consecutive pairs of scratch stores, i.e. per
forward row of the unrolled loop.

Usage (repo root, on a machine with a CUDA GPU and the CUDA toolkit):
    python scripts/myers_fused_variants.py
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NO_WALK = ("  for (int g = B / 16 - 1; g >= 0; --g) {\n    uint32_t tk[4]",
           "  for (int g = -1; g >= 0; --g) {\n    uint32_t tk[4]")
STORES = ("    tb_rows[o] = make_uint4(nl[0], nl[1], nl[2], nl[3]);\n"
          "    tb_rows[o + 1] = make_uint4(up[0], up[1], up[2], up[3]);")
VARIANTS = {
    "base": [],
    "no_walk": [NO_WALK],
    "no_walk_no_store": [NO_WALK, (STORES, "    if (nl[0] == 0x12345u && up[1] == 0x777u) {\n" + STORES + "\n    }")],
    "split_scratch": [
        ("    const size_t o = 2 * (r * stride + n);  // the lane's own 32-byte sector of row r\n" + STORES,
         "    const size_t o = r * stride + n;\n"
         "    tb_rows[o] = make_uint4(nl[0], nl[1], nl[2], nl[3]);\n"
         "    tb_rows[o + 256 * stride] = make_uint4(up[0], up[1], up[2], up[3]);"),
        ("          const size_t o = 2 * ((r_lo + k - 1) * stride + n);\n"
         "          nlv[k] = tb_rows[o];\n          upv[k] = tb_rows[o + 1];",
         "          const size_t o = (r_lo + k - 1) * stride + n;\n"
         "          nlv[k] = tb_rows[o];\n          upv[k] = tb_rows[o + 256 * stride];"),
    ],
    "ahead4": [("constexpr int AHEAD = 8;", "constexpr int AHEAD = 4;")],
    "ahead16": [("constexpr int AHEAD = 8;", "constexpr int AHEAD = 16;")],
    "aln64": [("constexpr int ALN = 32;", "constexpr int ALN = 64;"), ("  __syncwarp();", "  __syncthreads();")],
    "aln128": [("constexpr int ALN = 32;", "constexpr int ALN = 128;"), ("  __syncwarp();", "  __syncthreads();")],
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("myers_fused_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms, mode_pattern, random_jobs
    from hairsplitter_tpu_torch.ops import _build
    from hairsplitter_tpu_torch.ops.align import BandSpec

    spec = BandSpec()
    B, T = spec.chunk, spec.t_width
    assert B == 256  # split_scratch writes the second half at row 256
    dev = torch.device("cuda")
    nvcc = _build._nvcc()
    with open(os.path.join(_build.CSRC_DIR, "myers_fused.cu")) as f:
        source = f.read()
    work = tempfile.mkdtemp(prefix="hs_variants_")

    def build(name, subs):
        d = os.path.join(work, name)
        os.makedirs(d)
        shutil.copy(os.path.join(_build.CSRC_DIR, "myers_common.cuh"), d)
        text = source
        for old, new in subs:
            assert old in text, f"{name}: the source no longer holds {old[:50]!r}"
            text = text.replace(old, new)
        with open(os.path.join(d, "myers_fused.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "lib.so")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, os.path.join(d, "myers_fused.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-2000:]}")
        lib = ctypes.CDLL(so)
        lib.hs_myers_fused.restype = ctypes.c_int
        lib.hs_myers_fused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        regs = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln]
        return lib, so, regs[-1] if regs else ""

    inputs, out, scratch = {}, {}, {}
    for n in (8192, 32768):
        q, ql, t, tl = random_jobs(np.random.default_rng(1), n, spec)
        out[n] = torch.empty((n, 16 + B), dtype=torch.uint8, device=dev)
        scratch[n] = torch.empty((B, n, 2, 4), dtype=torch.int32, device=dev)
        for kind, lens in (("rand", ql), ("fullq", np.full_like(ql, B))):
            for pattern, short in (("alternating", "alt"), ("global", "glo")):
                arrays = (q, t, lens, tl, mode_pattern(pattern, n))
                inputs[(n, kind, short)] = [torch.from_numpy(x).to(dev) for x in arrays]
    keys = sorted(inputs)

    def time_ms(lib, key):
        n = key[0]

        def launch():
            rc = lib.hs_myers_fused(*(x.data_ptr() for x in inputs[key]), n, B, T, scratch[n].data_ptr(),
                                    out[n].data_ptr(), torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
        return cuda_ms(launch, 20)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}; times in ms")
    print(f"{'variant':18s}" + "".join(f"{f'{n}/{kind}/{pat}':>17s}" for n, kind, pat in keys))
    base_so = None
    for name, subs in VARIANTS.items():
        lib, so, regs = build(name, subs)
        base_so = base_so or so
        print(f"{name:18s}" + "".join(f"{time_ms(lib, k):17.4f}" for k in keys) + f"  {regs}", flush=True)

    # machine instructions per forward row of the committed kernel
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", base_so], capture_output=True, text=True).stdout
    ops = re.findall(r"^\s+/\*[0-9a-f]{4,5}\*/\s+((?:@!?U?P\d+\s+)?[A-Z0-9_.]+)", sass, re.M)
    stores = [i for i, op in enumerate(ops) if "STG" in op]
    gaps = [stores[i + 2] - stores[i] for i in range(0, len(stores) - 3, 2)]
    print(f"SASS: {len(ops)} instructions in the kernel; between consecutive pairs of scratch stores "
          f"(one forward row each, column minimum included; the last gaps are the readout and the walk): {gaps}")
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
