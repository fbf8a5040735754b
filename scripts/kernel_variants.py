"""What a CUDA kernel's time is made of: the tooling shared by
`myers_fused_variants.py` and `banded_fused_variants.py`.

A variants script names one kernel source of `hairsplitter_tpu_torch/csrc/`
and a table of edited copies of it, each a list of text substitutions
`(file, old, new)` in the source or a header. `run` builds the source as it
is and in every edited copy (in a temporary directory; the checkout is not
touched) and times each with CUDA events at 8,192 and 32,768 jobs of
`chip_smoke.py:random_jobs` (B = 256), for two kinds of input and two mode
patterns:
  rand   the jobs as drawn: query lengths from 0 to B;
  fullq  the same codes with every q_len = B, so every row is stepped;
  alt / glo   alternating global / extension modes, or all global.
Differences between variants in one call are meaningful; the edited copies
compute wrong or no tokens and are never used for anything else. `run`
returns the machine instructions of the committed kernel (`cuobjdump
-sass`), for the caller to count between its own marker instructions.
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

SIZES = (8192, 32768)


def run(source: str, variants: dict, bind, launch, report=lambda lib: "", sass_out: str | None = None) -> list[str]:
    """Times every variant of `csrc/<source>` and prints one table row each.

    bind(lib)                      sets the ctypes signatures of a built copy;
    launch(lib, arrays, n, out)    launches it once on `arrays` (q, t, q_lens,
                                   t_lens, modes on the card) into `out`
                                   (uint8 [n, 16 + B]) and returns its code;
    report(lib)                    text appended to the variant's row.
    Returns the opcodes of the committed kernel, in order."""
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, mode_pattern, random_jobs
    from hairsplitter_tpu_torch.ops import _build
    from hairsplitter_tpu_torch.ops.align import BandSpec

    spec = BandSpec()
    B = spec.chunk
    dev = torch.device("cuda")
    nvcc = _build._nvcc()
    texts = {}
    for name in (source, *_build.HEADERS):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    for name, subs in variants.items():  # before anything is built
        for fname, old, _ in subs:
            assert old in texts[fname], f"{name}: {fname} no longer holds {old[:50]!r}"
    work = tempfile.mkdtemp(prefix="hs_variants_")

    def build(name, subs):
        d = os.path.join(work, name)
        os.makedirs(d)
        edited = dict(texts)
        for fname, old, new in subs:
            edited[fname] = edited[fname].replace(old, new)
        for fname, text in edited.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        so = os.path.join(d, "lib.so")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, os.path.join(d, source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-2000:]}")
        lib = ctypes.CDLL(so)
        bind(lib)
        regs = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln]
        return lib, so, regs[-1] if regs else ""

    inputs, out = {}, {}
    for n in SIZES:
        q, ql, t, tl = random_jobs(np.random.default_rng(1), n, spec)
        out[n] = torch.empty((n, 16 + B), dtype=torch.uint8, device=dev)
        for kind, lens in (("rand", ql), ("fullq", np.full_like(ql, B))):
            for pattern, short in (("alternating", "alt"), ("global", "glo")):
                arrays = (q, t, lens, tl, mode_pattern(pattern, n))
                inputs[(n, kind, short)] = [torch.from_numpy(x).to(dev) for x in arrays]
    keys = sorted(inputs)

    def time_ms(lib, key):
        def once():
            rc = launch(lib, inputs[key], key[0], out[key[0]])
            assert rc == 0, rc
        return cuda_ms(once, 20)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}; times in ms")
    print(f"{'variant':18s}" + "".join(f"{f'{n}/{kind}/{pat}':>17s}" for n, kind, pat in keys))
    base_so = None
    for name, subs in variants.items():
        lib, so, regs = build(name, subs)
        base_so = base_so or so
        extra = "; ".join(x for x in (regs, report(lib)) if x)
        print(f"{name:18s}" + "".join(f"{time_ms(lib, k):17.4f}" for k in keys) + f"  {extra}", flush=True)

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", base_so], capture_output=True, text=True).stdout
    if sass_out:
        with open(sass_out, "w") as f:
            f.write(sass)
    shutil.rmtree(work, ignore_errors=True)
    return re.findall(r"^\s+/\*[0-9a-f]{4,5}\*/\s+((?:@!?U?P\d+\s+)?[A-Z0-9_.]+)", sass, re.M)
