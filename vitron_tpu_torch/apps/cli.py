"""CLI: one multimodal chat turn without a UI (port of `vitron_tpu/apps/cli.py`).

  python -m vitron_tpu_torch.apps.cli --demo --device cuda --prompt "what is this?"
  python -m vitron_tpu_torch.apps.cli --demo --device cpu --image img.npy --bbox 10 10 80 90 \
      --prompt "describe the region"

  python -m vitron_tpu_torch.apps.cli --base-model vicuna-7b --lora vitron_lora \
      --clip-tower clip_vit_l14 --quantize int4 --image img.npy --prompt "..."
  python -m vitron_tpu_torch.apps.cli --weights weights/ --quantize int4 --prompt "..."

`--demo` runs the tiny random-weight model with a whitespace tokenizer;
`--weights` the whole A-G deployment from a weights directory
(`runtime/assembly.build_system_from_weights`), `--base-model` the chat
system from checkpoint paths (`build_mllm_system`); both take the serve
app's flags, and a missing component they need is exit 2 with the reason. The image is a uint8
[H, W, 3] array saved with numpy (`--image x.npy`) or, if none is given,
random pixels from `--seed`. It runs on the card unless `--device cpu` asks
for the CPU: `cuda` (the default) on a machine without a CUDA device is an
error, never a switch to the CPU. Under `torchrun --nproc-per-node N` every
rank runs the same turn on the serving mesh (`--mesh auto`) and rank 0
prints it.
"""
from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np


class DemoTokenizer:
    """Deterministic whitespace tokenizer: id = crc32(word) % 200 + 10
    (crc32, unlike hash(), is the same in every process)."""

    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, s):
        class Encoded:
            pass

        enc = Encoded()
        enc.input_ids = [1] + [zlib.crc32(w.encode()) % 200 + 10 for w in s.split()]
        return enc

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"tok{t}" for t in ids)


def build_argparser() -> argparse.ArgumentParser:
    from vitron_tpu_torch.apps.serve import add_checkpoint_args

    p = argparse.ArgumentParser(description="Vitron PyTorch/CUDA CLI inference")
    add_checkpoint_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    p.add_argument("--demo", action="store_true",
                   help="random tiny weights, whitespace tokenizer (no checkpoints)")
    p.add_argument("--image", help="uint8 [H, W, 3] image saved with numpy (.npy)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--bbox", type=float, nargs=4, metavar=("X1", "Y1", "X2", "Y2"),
                   help="region of interest in image pixels")
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--top-p", type=float, default=0.7)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


DEMO_HOST_BUDGET = 4 * 1024 ** 3  # the demo's memory budget off the card (tiny needs MBs)


def build_demo_system(device, seed: int = 0):
    """The tiny demo system on `device`: its memory plan's budget is the
    card's memory, or DEMO_HOST_BUDGET off the card."""
    import torch

    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
    from vitron_tpu_torch.runtime.system import VitronSystem

    device = torch.device(device)
    cfg = vitron_model.VitronConfig.tiny()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = vitron_model.init_params(gen, cfg, device)
    plan = None if device.type == "cuda" else MemoryPlan(budget_bytes=DEMO_HOST_BUDGET)
    return VitronSystem(VitronEngine(params, cfg, DemoTokenizer(), device=device),
                        memory_plan=plan)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2
    if not args.demo and not args.base_model and not args.weights:
        print("error: provide --weights DIR, --base-model or --demo", file=sys.stderr)
        return 2
    from vitron_tpu_torch.apps.serve import build_app_system
    from vitron_tpu_torch.core import distributed as vdist
    from vitron_tpu_torch.runtime.assembly import MeshUnavailable, MissingWeightsError
    from vitron_tpu_torch.runtime.generation import SamplingConfig

    vdist.initialize(backend="gloo" if device.type == "cpu" else "nccl")  # under torchrun
    try:
        system, report = build_app_system(args, device)
    except (MissingWeightsError, NotImplementedError, MeshUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if report is not None and vdist.is_primary():
        print(report.summary(), file=sys.stderr)
    if args.image:
        image = np.load(args.image)
    else:
        image = np.random.RandomState(args.seed).randint(0, 256, (336, 448, 3), np.uint8)
    sampling = SamplingConfig(temperature=args.temperature, top_p=args.top_p,
                              max_new_tokens=args.max_new_tokens, greedy=args.greedy)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    result = system.chat(args.prompt, image=image, region_box=args.bbox,
                         sampling=sampling, gen=gen)
    if not vdist.is_primary():
        return 0
    print(f"[status] {result['status']}")
    if result.get("task"):
        print(f"[task]   {result['task']}")
    print(f"[reply]  {result['reply']['raw']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
