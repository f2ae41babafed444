#!/usr/bin/env python3
"""Time F, the verify forwards a speculative graph replay runs
(`vitron_tpu_torch.runtime.generation.SPEC_FORWARDS`), on one card.

    python3 tools/spec_forwards.py [--forwards 4 8 16] [--new 256] [--turns 2]
                                   [--out FILE.json]

On the smoke's chat system (`chip_smoke.build_chat_system`: Vicuna-7B with
random packed-int4 weights, flash prefill, bf16 ViT-L/14) and its image
chat request with a box (`chip_smoke.spec_request`), for each F:
speculative=True over --new greedy tokens, whole (one segment) and in
64-token segments (a KeywordStopper that never fires). F is set on the
module constant, so each F captures its own graph on a first call; then
--turns calls of each are timed (host clock, synchronized) and the best
kept. Each stream is held against the plain graphed greedy stream of the
same request (identical, or a near-tie `chip_smoke.check_divergence`
accepts). Prints, for each F, the request seconds, tok/s, forwards that
emitted and replays, and writes them to --out. Every masked forward costs
a whole forward, so a larger F pays more at each segment's end. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from flash_rows import HERE, load_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forwards", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--new", type=int, default=256, help="new tokens a request")
    ap.add_argument("--turns", type=int, default=2, help="timed calls of each, best kept")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from vitron_tpu_torch.kernels import _build
    from vitron_tpu_torch.mm.tokenization import KeywordStopper
    from vitron_tpu_torch.runtime import generation as gmod

    if not torch.cuda.is_available():
        print("spec_forwards: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = load_smoke()
    card = smoke.nvidia_smi_line()
    _build.lib()
    rows = []
    with torch.no_grad():
        system, _, _ = smoke.build_chat_system(torch)
        gen_ = system.engine.generator
        image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
        plan, kw, pre = smoke.spec_request(torch, system, image)
        arrays = smoke.plan_arrays(plan)
        sampling = gmod.SamplingConfig(greedy=True, max_new_tokens=args.new, eos_ids=())
        stop = KeywordStopper(["no such stop string"], system.engine.tokenizer, prompt_len=0)

        def run(**gkw):
            return gen_.generate(plan, sampling=sampling, **kw, **gkw)[0]

        def best(fn):
            out = []
            for _ in range(args.turns):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = fn()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0, toks, dict(gen_.last_spec_stats or {}),
                            [r for _, _, r in gen_.last_spec_segments]))
            return min(out, key=lambda r: r[0])

        run(speculative=False)
        plain = run(speculative=False)
        slots = gen_.last_chunk.cache.k.shape[2]
        for f in args.forwards:
            gmod.SPEC_FORWARDS = f
            for how, gkw in (("whole", {}), ("segments", {"stopper": stop})):
                run(speculative=True, **gkw)  # captures this F's graph
                s, toks, st, replays = best(lambda: run(speculative=True, **gkw))
                smoke.check_divergence(
                    f"spec_forwards F={f} {how}", toks, plain,
                    lambda j: smoke.stream_logits(torch, gen_, arrays, kw["images"].cuda(),
                                                  plain, j, slots, **pre), card)
                r = {"F": f, "how": how, "s": s, "tok_s": len(toks) / s,
                     "forwards": st["forwards"], "replays": replays,
                     "masked": f * sum(replays) - st["forwards"] + 1}
                rows.append(r)
                print(f"spec_forwards: F={f} {how}: {len(toks)} tokens in {s:.4f} s "
                      f"({r['tok_s']:.1f} tok/s), forwards {r['forwards']}, replays {replays}, "
                      f"masked forwards {r['masked']} [{card}]", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "new_tokens": args.new, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
