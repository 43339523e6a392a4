#!/usr/bin/env python3
"""The TF32 flash forwards' float64 error at one head dim over many seeded
inputs, on one CUDA card.

    python3 tools/torch_tf32_fwd_error.py [--d 88] [--inputs 64]

At each of two shapes ([1, 3, 130, 193] and [2, 8, 256, 256] at head dim
d) and each of `inputs` seeded draws, the largest element's and the
norm's error against float64 attention of: the TF32 wgmma kernel
(csrc/flash_attn_fwd_tf32_sm90.cu, 16-byte rows), the TF32 register kernel
(csrc/flash_attn_fwd.cu, the same values on rows of d + 1 floats), the
plain version `attention_reference_tf32` (q, k, the normalised
probabilities and v rounded to TF32) and a plain model of the kernels'
order (the unnormalised probabilities rounded, the row sum divided after
the product). Prints, per shape, the ratios of the kernels' errors to the
plain version's and to the model's: their mean, their largest and how many
pass 1.5x.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=88)
    ap.add_argument("--inputs", type=int, default=64)
    args = ap.parse_args()
    import torch
    from chip_smoke import card_line
    from neurons_tpu_torch.ops import attention as attn

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    d = args.d

    def unnormalised(q, k, v):
        s = attn._tf32_matmul(q, k.transpose(-1, -2)) * d ** -0.5
        e = torch.exp(s - s.amax(-1, keepdim=True))
        return attn._tf32_matmul(e, v) / e.sum(-1, keepdim=True)

    def off16(x):
        buf = torch.zeros(x.shape[:-1] + (x.shape[-1] + 1,), device=x.device)
        buf[..., :x.shape[-1]] = x
        return buf[..., :x.shape[-1]]

    for b, h, tq, tk in ((1, 3, 130, 193), (2, 8, 256, 256)):
        errs = []  # per input: max errors, then norms, of the four
        for seed in range(args.inputs):
            g = torch.Generator("cuda").manual_seed(1000 + seed)
            q = torch.randn((b, h, tq, d), generator=g, device="cuda")
            k, v = (torch.randn((b, h, tk, d), generator=g, device="cuda")
                    for _ in range(2))
            outs = (attn.flash_attention_fwd(q, k, v),
                    attn.flash_attention_fwd(off16(q), off16(k), off16(v)),
                    attn.attention_reference_tf32(q, k, v),
                    unnormalised(q, k, v))
            want = attn.attention_reference(q.double(), k.double(), v.double())
            e = [(x.double() - want) for x in outs]
            errs.append([x.abs().max().item() for x in e]
                        + [x.norm().item() for x in e])
        t = torch.tensor(errs, dtype=torch.float64)

        def stats(r):
            return (f"mean {r.mean():.3f} max {r.max():.3f} "
                    f"(> 1.5: {int((r > 1.5).sum())})")

        print(f"d {d} [{b},{h},{tq},{tk}], {args.inputs} inputs: the largest "
              f"element's error over the plain version's: wgmma "
              f"{stats(t[:, 0] / t[:, 2])}, register {stats(t[:, 1] / t[:, 2])},"
              f" the unnormalised model {stats(t[:, 3] / t[:, 2])}; wgmma over "
              f"the model {stats(t[:, 0] / t[:, 3])}; the norm's, wgmma over "
              f"plain {stats(t[:, 4] / t[:, 6])}; mean largest errors: wgmma "
              f"{t[:, 0].mean():.3e}, register {t[:, 1].mean():.3e}, plain "
              f"{t[:, 2].mean():.3e}, model {t[:, 3].mean():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
