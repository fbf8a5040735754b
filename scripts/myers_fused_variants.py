"""What the fused Myers kernel's time is made of, on one GPU.

Builds `hairsplitter_tpu_torch/csrc/myers_fused.cu` as it is and in a few
edited copies and times each, as `scripts/kernel_variants.py` describes
(inputs rand / fullq, modes alt / glo, 8,192 and 32,768 jobs; here one
thread owns one alignment, so `rand` mixes query lengths within a warp).
Variants:
  base              the kernel as committed;
  no_walk           forward pass only (the walk's loop bound set to -1);
  no_walk_no_store  forward pass with the scratch stores made unreachable;
  split_scratch     nonleft and isup words in two [B, N, 4] halves of the
                    scratch, 16 B per lane and row in each (half a sector),
                    instead of one 32-byte sector per lane and row;
  ahead4, ahead16   the walk loading 4 or 16 rows at once instead of 8;
  aln64, aln128     blocks of 2 or 4 warps instead of one.
Then prints, from `cuobjdump -sass` of the committed kernel, the number of
machine instructions between consecutive pairs of scratch stores, i.e. per
forward row of the unrolled loop.

Usage (repo root, on a machine with a CUDA GPU and the CUDA toolkit):
    python scripts/myers_fused_variants.py
"""

from __future__ import annotations

import ctypes
import sys

import kernel_variants

FUSED = "myers_fused.cu"
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


def bind(lib) -> None:
    lib.hs_myers_fused.restype = ctypes.c_int
    lib.hs_myers_fused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("myers_fused_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    scratch = {}  # the walk's (nonleft, isup) words [B, n, 2, 4], one per batch size

    def launch(lib, arrays, n, out):
        B, T = arrays[0].shape[1], arrays[1].shape[1]
        assert B == 256  # split_scratch writes the second half at row 256
        if n not in scratch:
            scratch[n] = torch.empty((B, n, 2, 4), dtype=torch.int32, device=out.device)
        return lib.hs_myers_fused(*(x.data_ptr() for x in arrays), n, B, T, scratch[n].data_ptr(),
                                  out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    variants = {name: [(FUSED, old, new) for old, new in subs] for name, subs in VARIANTS.items()}
    ops = kernel_variants.run(FUSED, variants, bind, launch)
    # machine instructions per forward row of the committed kernel
    stores = [i for i, op in enumerate(ops) if "STG" in op]
    gaps = [stores[i + 2] - stores[i] for i in range(0, len(stores) - 3, 2)]
    print(f"SASS: {len(ops)} instructions in the kernel; between consecutive pairs of scratch stores "
          f"(one forward row each, column minimum included; the last gaps are the readout and the walk): {gaps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
