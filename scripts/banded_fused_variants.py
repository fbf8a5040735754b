"""What the fused int32 banded-DP kernel's time is made of, on one GPU.

Builds `hairsplitter_tpu_torch/csrc/banded_fused.cu` as it is and in a few
edited copies and times each, as `scripts/kernel_variants.py` describes
(inputs rand / fullq, modes alt / glo, 8,192 and 32,768 jobs). Variants:
  base              the kernel as committed;
  no_walk           forward pass and readout only (the walk starts at row 0);
  no_walk_no_store  the same with the class scratch stores made unreachable;
  no_column         the column minimum never folded (extension jobs too);
  no_classes        the diagonal class compare dropped;
  mask_both         every row masks the cells outside 0 <= j <= tlen, as the
                    check mode does, instead of no cell;
  shift_diag        the diagonal candidate by shift, mask and add per cell
                    instead of one byte dot product;
  lane_test_scan    the prefix-min scan with a lane test in every step;
  no_stage_t        the target staged as sentinels only (no global reads of t);
  warps2, warps4, warps8   blocks of 2, 4 or 8 warps instead of one.
`base - no_walk` is the walk, `no_walk - no_walk_no_store` the stores.
Then prints, from `cuobjdump -sass` of the committed kernel, the number of
machine instructions between consecutive SHFL.DOWN instructions (one per
forward row of the unrolled group of four), and the kernel's occupancy.

Usage (repo root, on a machine with a CUDA GPU and the CUDA toolkit):
    python scripts/banded_fused_variants.py [SASS_OUT]
With SASS_OUT, also writes the committed kernel's machine code there.
"""

from __future__ import annotations

import ctypes
import sys

import kernel_variants

FUSED, COMMON = "banded_fused.cu", "banded_common.cuh"
NO_WALK = (FUSED, "walk_warp(cls32, start_i, start_b,", "walk_warp(cls32, 0, start_b,")
STORE = "HS_EACH_LANE { cls32[g * 32 + lane] = acc[lane]; }"
VARIANTS = {
    "base": [],
    "no_walk": [NO_WALK],
    "no_walk_no_store": [NO_WALK, (FUSED, STORE, STORE.replace("{ cls32", "{ if (acc[lane] == 0x12345678u) cls32"))],
    "no_column": [(FUSED, "if (is_ext) hsb::lane_col_update(", "if (tlen < -5) hsb::lane_col_update(")],
    "no_classes": [(COMMON, "cls |= (static_cast<uint32_t>(r == diag.c[c]) << c)", "cls |= (0u << c)")],
    "mask_both": [(FUSED, "hsb::dp_row<hsb::MASK_NONE>", "hsb::dp_row<hsb::MASK_BOTH>")],
    "shift_diag": [(COMMON, "diag.c[c] = __dp4a(ne, static_cast<int>(0xFFu << (8 * c)), x.c[c]);",
                    "diag.c[c] = x.c[c] + static_cast<int32_t>((static_cast<uint32_t>(ne) >> (8 * c)) & 1u);")],
    "lane_test_scan": [(COMMON, "a = imin(a, __shfl_up_sync(FULL, a, d));",
                        "{ const int32_t o = __shfl_up_sync(FULL, a, d); if ((threadIdx.x & 31u) >= d) a = imin(a, o); }")],
    "no_stage_t": [(FUSED, "ts[k] = (j >= 0 && j < T) ? static_cast<uint8_t>(tn[j])",
                    "ts[k] = (j >= 0 && j < -T) ? static_cast<uint8_t>(tn[j])")],
    "warps2": [(FUSED, "constexpr int WARPS = 1;", "constexpr int WARPS = 2;")],
    "warps4": [(FUSED, "constexpr int WARPS = 1;", "constexpr int WARPS = 4;")],
    "warps8": [(FUSED, "constexpr int WARPS = 1;", "constexpr int WARPS = 8;")],
}


def bind(lib) -> None:
    lib.hs_banded_fused.restype = ctypes.c_int
    lib.hs_banded_fused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.hs_banded_fused_occupancy.restype = ctypes.c_int
    lib.hs_banded_fused_occupancy.argtypes = [ctypes.c_int]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("banded_fused_variants: needs a CUDA GPU", file=sys.stderr)
        return 1

    def launch(lib, arrays, n, out):
        return lib.hs_banded_fused(*(x.data_ptr() for x in arrays), n, arrays[0].shape[1], arrays[1].shape[1],
                                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    ops = kernel_variants.run(
        FUSED, VARIANTS, bind, launch,
        report=lambda lib: f"{lib.hs_banded_fused_occupancy(256)} blocks per SM",
        sass_out=sys.argv[1] if len(sys.argv) > 1 else None,
    )
    # machine instructions per forward row of the committed kernel
    marks = [i for i, op in enumerate(ops) if "SHFL.DOWN" in op]
    gaps = [b - a for a, b in zip(marks, marks[1:])]
    kinds = {}
    for op in ops[marks[0]:marks[-1]] if len(marks) > 1 else []:
        base = op.split()[-1].split(".")[0]
        kinds[base] = kinds.get(base, 0) + 1
    print(f"SASS: {len(ops)} instructions in the kernel; between consecutive SHFL.DOWN (one forward row each): "
          f"{gaps}; by opcode over those rows: {dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
