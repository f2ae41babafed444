#!/usr/bin/env python3
"""Time the paths that the flash kernels move most, for one checkout of the
repo, so a change can be held against its parent in turns on one card.

    python3 tools/path_turns.py [--train] [--root CHECKOUT] [--label NAME]

It runs the smoke's own phases (`chip_smoke.py` of the checkout this script
lies in) on the `vitron_tpu_torch` of `--root` (default: this checkout),
with the smoke's settings (TF32 off, deterministic cuDNN): task A
(`phase_task_a`: the full-width SD v1.4 GLIGEN request twice, its request
time and ms per CFG UNet call) and the bf16 CFG UNet step rate
(`phase_sd_unet_bf16`), where B2 runs; or, with `--train`, phase 19's
training step (`phase_train`: Trainer.fit on the full-width Vicuna-7B int4
+ ViT-L/14, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ twice, its step
time, trained tokens/s and a profiled step by kernel group), where B2, B5a
and B5b run. Run it once a process, parent, change, change, parent, in one
call: the host's share of these reads differs between machines. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from flash_rows import HERE, load_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true", help="phase 19's training step")
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from vitron_tpu_torch.kernels import _build
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig
    from vitron_tpu_torch.models.diffusion.unet2d import UNetConfig

    if not torch.cuda.is_available():
        print("path_turns: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    smoke = load_smoke()
    card = smoke.nvidia_smi_line()
    _build.lib()
    print(f"{args.label}: {_build.library_path()} on {card}", flush=True)
    if args.train:
        smoke.phase_train(torch, f"{args.label}, {card}")
        return 0
    dev = torch.device("cuda")
    with torch.no_grad():
        pipe = smoke.build_gligen(torch, GligenConfig(), dev, seed=0)
        smoke.phase_task_a(torch, f"{args.label}, {card}", pipe)
        del pipe
        torch.cuda.empty_cache()
        smoke.phase_sd_unet_bf16(torch, f"{args.label}, {card}", UNetConfig.sd_v1(), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
