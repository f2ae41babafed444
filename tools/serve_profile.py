#!/usr/bin/env python3
"""Where the graphed decode's time goes on the card: a torch.profiler trace
of one replayed decode chunk of the chat system (`generate_scan`'s 127
steps at `bench_e2e_request`'s shape, phase 6b of `chip_smoke.py`) and of
one replayed `PagedServer.step_n` chunk of 64 steps at batch 1 and 4
(`bench_continuous_batching`'s shape), the device time summed by kernel
group and divided by the steps, beside the unprofiled time of a step.

    python3 tools/serve_profile.py [--out FILE.json]

Builds the smoke's full-width chat system (`chip_smoke.build_chat_system`:
Vicuna-7B with random packed-int4 weights, bf16 ViT-L/14). Needs one CUDA
device; prints the card's `nvidia-smi` name and power limit with every line.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np
from flash_rows import HERE, load_smoke

# the first pattern that matches a kernel's name names its group
GROUPS = (
    ("B1 int4_matmul", r"int4_(gemv|gemm)"),
    ("products (cuBLAS: einsum attention)", r"gemm|gemv|cutlass|xmma|nvjet|bmm"),
    ("softmax", r"softmax"),
    ("reductions", r"reduce"),
    ("sort and scan (sampling)", r"sort|scan|radix"),
    ("index, gather, scatter, copies", r"index|gather|scatter|copy|cat"),
)


def profiled_ms(torch, call) -> dict:
    """Device ms of one call's kernels by group, and in all."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {name: 0.0 for name, _ in GROUPS}
    out["the rest (elementwise)"] = 0.0
    kernels = 0
    for e in prof.key_averages():
        if e.device_type != cuda or e.self_device_time_total <= 0:
            continue
        name = next((n for n, pat in GROUPS if re.search(pat, e.key)), "the rest (elementwise)")
        out[name] += e.self_device_time_total / 1e3
        kernels += e.count
    out["busy"] = sum(v for k, v in out.items())
    out["kernels"] = kernels
    return out


def wall_ms(torch, call) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def report(what: str, steps: int, tokens: int, wall: float, prof: dict, card: str) -> dict:
    per = {k: v / steps for k, v in prof.items() if k not in ("kernels",)}
    print(f"{what}: a step {wall / steps:.3f} ms unprofiled ({tokens / wall * 1e3:.1f} tok/s), "
          f"device busy {per['busy']:.3f} ms a step, {prof['kernels'] / steps:.0f} kernels a "
          f"step; by group (ms a step): "
          + "; ".join(f"{k} {v:.3f}" for k, v in per.items() if k != "busy") + f" [{card}]",
          flush=True)
    return {"what": what, "step_ms": wall / steps, "tok_s": tokens / wall * 1e3,
            "kernels_per_step": prof["kernels"] / steps, "ms_per_step": per, "card": card}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="write the rows as JSON here")
    args = p.parse_args()
    sys.path.insert(0, str(HERE))
    smoke = load_smoke()
    card = smoke.nvidia_smi_line()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from vitron_tpu_torch.models.llm.paged_cache import PagedServer
    from vitron_tpu_torch.runtime.engine import MediaItem, prepare_batch
    from vitron_tpu_torch.runtime.generation import generate_scan

    dev = torch.device("cuda")
    rows = []
    with torch.no_grad():
        system, params, cfg = smoke.build_chat_system(torch)
        gen_ = system.engine.generator
        size = cfg.image_tower.image_size
        px = torch.rand((size, size, 3), generator=torch.Generator().manual_seed(1))
        plan, images, _, _ = prepare_batch([[1] + [7] * 24 + [IMAGE_TOKEN_INDEX] + [9] * 24],
                                           [MediaItem("image", px)],
                                           image_len=cfg.image_tower.num_patches)
        arrays = smoke.plan_arrays(plan)
        toks = generate_scan(params, cfg, arrays, smoke.SCAN_NEW, images=images.to(dev),
                             generator=gen_)[0].tolist()
        chunk = gen_.last_chunk
        seq = torch.as_tensor(plan.seq_lens, device=dev)[:, None]

        def replay():
            chunk.start(torch.tensor([[toks[0]]], device=dev), seq, plan.token_ids.shape[1],
                        0.0, 1.0)
            chunk.run()

        steps = smoke.SCAN_NEW - 1
        wall = min(wall_ms(torch, replay) for _ in range(3))
        rows.append(report("graphed decode (generate_scan, batch 1)", steps, steps, wall,
                           profiled_ms(torch, replay), card))

        rs = np.random.RandomState(0)
        prompts = [[int(t) for t in rs.randint(1, 30000, smoke.SERVE_PREFILL)] for _ in range(4)]
        n = smoke.SERVE_CHUNK
        for batch in (prompts[:1], prompts):
            srv = PagedServer(params["llm"], cfg.llm, num_blocks=48 * len(batch), block_size=16,
                              max_blocks_per_seq=32)
            sids = [srv.add_request(q, chunk=smoke.SERVE_PREFILL) for q in batch]
            sampling = {sid: (0.0, 1.0, True) for sid in sids}
            sampling["uniforms"] = torch.zeros((n, len(sids)), device=dev)
            srv.step_n(n, sampling=sampling)  # captures
            fn = srv._chunk_fns.lookup((n, len(sids), srv.max_blocks, True))
            wall = min(wall_ms(torch, fn.run) for _ in range(3))
            rows.append(report(f"paged step_n (batch {len(sids)})", n, n * len(sids), wall,
                               profiled_ms(torch, fn.run), card))
            del srv, fn
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
