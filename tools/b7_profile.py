#!/usr/bin/env python3
"""A torch.profiler trace of B7 (`frame_attention`) at one t2v level's shape,
below and above 32 frames, with each kernel launch's configuration.

    python3 tools/b7_profile.py [--frames 32 40 64] [--out DIR]

For each frame count F and type (float32, bf16) it runs the kernel on
q, k, v [2, F, 2880, 512] (the t2v UNet's first level: 8 heads of 64) a few
times under `torch.profiler` with CUDA activity, writes the Chrome trace to
`--out` (default `chiprun_out/`), and prints one line per kernel: its
name, mean device time, grid and block, registers per thread, shared
memory, warps per SM and the profiler's estimated achieved occupancy (as
CUPTI reports them in the trace's kernel events), and the rate at which it
moves q, k, v and the output once. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

B, N, C, HEADS = 2, 2880, 512, 8
REPS = 5
LAUNCH_KEYS = ("grid", "block", "registers per thread", "shared memory", "warps per SM",
               "blocks per SM", "est. achieved occupancy %")


def kernel_events(trace_path: Path) -> list:
    """The trace's device kernel events (category "kernel")."""
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    return [e for e in events if e.get("cat") == "kernel"]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[32, 40, 64])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from vitron_tpu_torch.kernels import temporal_attention as ta

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    d = C // HEADS
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    for f in args.frames:
        qkv = [torch.randn((B, f, N, C), generator=g, device=dev) for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in qkv)
            ta.frame_attention(q, k, v, HEADS, d ** -0.5)  # build and warm up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    ta.frame_attention(q, k, v, HEADS, d ** -0.5)
                torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            trace = out_dir / f"b7_profile_F{f}_{name}.json"
            prof.export_chrome_trace(str(trace))
            kernels = [e for e in kernel_events(trace) if "frame_attention" in e.get("name", "")]
            if not kernels:
                print(f"F {f} {name}: no frame_attention kernel in the trace", flush=True)
                continue
            dur_us = statistics.mean(e["dur"] for e in kernels)
            moved = 4 * q.numel() * q.element_size()
            launch = {key: kernels[0].get("args", {}).get(key) for key in LAUNCH_KEYS}
            print(f"F {f} {name}: {kernels[0]['name']}: {len(kernels)} launches, mean "
                  f"{dur_us / 1e3:.4f} ms, {moved / (dur_us * 1e-6) / 1e9:.0f} GB/s of q, k, v "
                  f"and out once; " + ", ".join(f"{k_}={v_}" for k_, v_ in launch.items()),
                  flush=True)
        del qkv
    return 0


if __name__ == "__main__":
    sys.exit(main())
