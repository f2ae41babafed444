#!/usr/bin/env python3
"""Time the port's int4 matrix product (B1), frame attention (B7), 3x3 conv
(B9) and depthwise conv (B4) at the shapes that `chip_smoke.py` holds them
at, for one checkout of the repo.

    python3 tools/kernel_rows.py [--root CHECKOUT] [--label NAME] [--out FILE.json]
                                 [--kernels B1,B7,B9,B4]

The rows are the smoke's own (`int4_row` at M 1 and 384 for the four
Vicuna-7B (K, N) pairs and at the trainer's M 4096; `frame_attention_row`
at `b7_shapes`, float32 and bf16), from the checkout this script lies in;
`--root` names the checkout whose `vitron_tpu_torch` is imported (default:
this one), so two versions of the kernels can be timed in turns on one
card (parent, change, change, parent: one process each). Each row prints
the kernel's time (B1: CUDA events, the weights flushed from L2 at M 1 and
384; B7: CUDA-graph replay), the plain version's, the bound and the error;
B1 beside torch.matmul on the pre-dequantized bf16 weight (a reference on
other inputs, not a port), B7 beside F.scaled_dot_product_attention. The
B1 rows at M 1 and 384 are also timed with the flush buffer written before
each run, the smoke's method up to PR 9, which leaves ~50 MB of dirty lines
in L2 whose write-back lands on the timed call. B9's rows are the smoke's
`conv3x3_row` at `b9_sites` (task G's 16 eligible 3x3 convs, float32 and
bf16, CUDA events, beside cuDNN's bf16 conv), B4's its `dw_row` at
`DW_SHAPES` (FocalNet-L's 16 sites and a ragged one) and `NEW_DW_SITES`
(ConvNeXt-T's and DaViT-T's 8, where the checkout has them), float32 and
bf16, CUDA-graph replay, beside F.conv2d(groups=C)), each with its bound, error
at the largest output and at each pixel's scale, and the same bits twice.
`--kernels` picks which of the four to time. `--out` writes the rows as
JSON. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from flash_rows import HERE, load_smoke


class WrittenFlush:
    """A flush for `cuda_ms` that rewrites the buffer (dirty lines in L2)
    where the smoke's reads it."""

    def __init__(self, buf):
        self.buf = buf

    def max(self):
        self.buf.zero_()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", default="B1,B7,B9,B4")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from vitron_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("kernel_rows: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = load_smoke()
    card = f"{args.label}, {smoke.nvidia_smi_line()}"
    _build.lib()
    print(f"{args.label}: {_build.library_path()}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows = []
    with torch.no_grad():
        if "B9" in kernels:
            bsz = 2 * smoke.I2V_FRAMES
            for h, w, c, d in smoke.b9_sites(torch, bsz)[0]:
                x32 = torch.randn((bsz, h, w, c), generator=g, device=dev)
                w32 = torch.randn((3, 3, c, d), generator=g, device=dev) / (9 * c) ** 0.5
                for dtype in (torch.float32, torch.bfloat16):
                    r = smoke.conv3x3_row(torch, card, x32, w32, dtype)
                    rows.append({"kernel": "B9", "shape": [bsz, h, w, c, d],
                                 "dtype": str(dtype).split(".")[-1], **r})
                del x32, w32
                torch.cuda.empty_cache()
        if "B4" in kernels:
            for shape, k in list(smoke.DW_SHAPES) + list(getattr(smoke, "NEW_DW_SITES", ())):
                x32 = torch.randn(shape, generator=g, device=dev)
                w32 = torch.randn((k, k, shape[-1]), generator=g, device=dev) / k
                for dtype in (torch.float32, torch.bfloat16):
                    r = smoke.dw_row(torch, card, x32, w32, dtype)
                    rows.append({"kernel": "B4", "shape": [*shape, k],
                                 "dtype": str(dtype).split(".")[-1], **r})
        for m in (1, 384, smoke.TRAIN_BATCH * smoke.TRAIN_SEQ) if "B1" in kernels else ():
            for k, n in smoke.INT4_SHAPES:
                big = m > 384
                r = smoke.int4_row(torch, card, g, m, k, n, flush=None if big else flush,
                                   iters=5 if big else 20)
                rows.append({"kernel": "B1", "shape": [m, k, n], **r})
                torch.cuda.empty_cache()
        for b, f, n, c, heads in smoke.b7_shapes() if "B7" in kernels else ():
            qkv32 = [torch.randn((b, f, n, c), generator=g, device=dev) for _ in range(3)]
            for dtype in (torch.float32, torch.bfloat16):
                r = smoke.frame_attention_row(torch, card, qkv32, heads, dtype)
                rows.append({"kernel": "B7", "shape": [b, f, n, c, heads],
                             "dtype": str(dtype).split(".")[-1], **r})
            del qkv32
        from vitron_tpu_torch.kernels import int4_matmul as i4

        written = WrittenFlush(flush)
        for m in (1, 384) if "B1" in kernels else ():
            for k, n in smoke.INT4_SHAPES:
                q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8,
                                   device=dev)
                s = torch.rand((1, n), generator=g, device=dev) * 0.02 + 0.01
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                ms = smoke.cuda_ms(torch, lambda: i4.int4_matmul(x, q4, s), flush=written)
                rows.append({"kernel": "B1 written flush", "shape": [m, k, n], "ms": ms})
                print(f"int4_matmul M={m} K={k} N={n} bf16, flush buffer written before each "
                      f"run: kernel {ms:.4f} ms [{card}]", flush=True)
    for m in (1, 384) if "B1" in kernels else ():
        read, written = (sum(r["ms"] for r in rows if r["kernel"] == kind and r["shape"][0] == m)
                         for kind in ("B1", "B1 written flush"))
        print(f"{args.label} B1 M={m}: kernel {read:.4f} ms (flush read), {written:.4f} ms "
              f"(flush written) over the four (K, N) [{card}]", flush=True)
    for kernel in ("B1", "B7", "B9", "B4"):
        for dtype in ("float32", "bfloat16", None):
            rs = [r for r in rows if r["kernel"] == kernel and r.get("dtype") == dtype]
            if rs:
                smoke.print_sums(f"{args.label} {kernel} {dtype or ''}", rs, card)
    if args.out:
        Path(args.out).write_text(json.dumps({"label": args.label, "card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
