"""The smoke's phase 27 alone: the whole A-G deployment from one weights
directory, on one card.

Builds the kernels, writes the files that `chip_smoke.py`'s phases 25 and 26
put into the deployment's directory (`write_deployment`: the Vicuna-7B
shards, the LoRA adapter, the CLIP and LanguageBind towers;
`write_gligen_bundle`: GLIGEN's two fp16 bundles from `build_gligen`'s
trees; `write_t2v_pth`: the t2v UNet as an fp16 `.pth` from `build_t2v`'s),
by the smoke's own writers, without their loads and checks, then runs
`chip_smoke.phase_weights` on it (the rest of the files, the load through
`build_system_from_weights`, the chat turn, tasks A-G) and removes the
directory. Each line it prints carries the card's name and power limit.

    python3 tools/weights_phase.py
"""
from __future__ import annotations

import os
import pathlib
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    import torch

    import chip_smoke as cs
    from vitron_tpu_torch.kernels import _build
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

    card = cs.nvidia_smi_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    dev = torch.device("cuda")
    root = cs.ckpt_root()
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            cs.write_deployment(torch, pathlib.Path(root), seed=25)
            pipe = cs.build_gligen(torch, GligenConfig(), dev, 0)
            for name, inpaint in cs.GLIGEN_BUNDLES:
                cs.write_gligen_bundle(torch, pipe, root, name, inpaint)
            del pipe
            torch.cuda.empty_cache()
            pipe = cs.build_t2v(torch, Text2VideoConfig(), dev, 0)
            cs.write_t2v_pth(torch, pipe, root)
            del pipe
            torch.cuda.empty_cache()
            print(f"phases 25 and 26's files written in {time.perf_counter() - t0:.1f} s "
                  f"[{card}]", flush=True)
            cs.timed_phase(card, "27", cs.phase_weights, torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
