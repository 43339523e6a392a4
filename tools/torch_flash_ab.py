#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention forward of two checkouts on one
CUDA card, in turns, at every attention shape of the full-width clip (the
inference launch: bf16, no bias, no log-sum-exp).

    python3 tools/torch_flash_ab.py OTHER_ROOT

OTHER_ROOT is a second checkout of the repository, e.g. the parent commit
unpacked with `git archive` into a directory that .gitignore lists. Each
checkout runs in its own process (it builds its own kernel), in the order
other, this, this, other; the last lines give, per shape, each process's
mean ms over 20 launches after a warm-up (chip_smoke.py's `cuda_ms`).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def time_here(root: str):
    """Times of `root`'s kernel, one JSON line on stdout."""
    sys.path.insert(0, root)
    import torch
    from chip_smoke import FLASH_SHAPES, cuda_ms
    from neurons_tpu_torch.ops import attention as attn

    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for name, (b, h, tq, tk, d) in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
        out[name] = cuda_ms(lambda: attn.flash_attention_fwd(q, k, v), 20)
    print(json.dumps(out))


def main():
    if sys.argv[1] == "--time":
        return time_here(sys.argv[2])
    other = str(Path(sys.argv[1]).resolve())
    runs = []
    for label, root in (("other", other), ("this", str(REPO)),
                        ("this", str(REPO)), ("other", other)):
        res = subprocess.run([sys.executable, __file__, "--time", root],
                             check=True, capture_output=True, text=True,
                             cwd=root, timeout=900)
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    for name in runs[0][1]:
        cells = "  ".join(f"{label} {times[name]:.4f}"
                          for label, times in runs)
        print(f"flash A/B {name:20s} ms: {cells}")


if __name__ == "__main__":
    sys.exit(main())
