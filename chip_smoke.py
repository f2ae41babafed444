#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vitron_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no `ok` line):
1. device: the `nvidia-smi` name and power limit; exit 1 without CUDA;
   TF32 off for matmuls and cuDNN.
2. build: the hand CUDA kernels from `vitron_tpu_torch/csrc/` (nvcc, sm_90a).
3. kernel vs plain at the chat path's shapes: int4_matmul (bf16 x, M in
   {1, 384}, the four Vicuna-7B (K, N) pairs) and flash_attention (bf16,
   D = 128: masked prefill, cached chunk, GQA); error and CUDA-event times.
4. the slice at full width: VitronSystem.chat on Vicuna-7B with random
   packed-int4 projections and lm_head + bf16 ViT-L/14 tower, projector and
   region extractor; a 336x448 image, a bbox, 128 greedy tokens, twice;
   kernel launch counts, request / prefill / decode times, peak memory.
5. the same code on the CPU and the card: a 2-layer full-width float32
   model, one prefill of the same request on both, last-position logits
   compared.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

INT4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
INT4_TOL = 1e-2   # max |kernel - plain| / max |plain|: bf16 output rounding
FLASH_TOL = 2e-2  # max |kernel - plain| on unit-normal bf16 inputs
CPU_GPU_TOL = 1e-3  # float32 on both sides: only the order of sums differs
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BBOX = [60.0, 40.0, 300.0, 260.0]
PROMPT = "What is the object in the marked region doing?"
NEW_TOKENS = 128


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi gave nothing"


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median CUDA-event time of fn() in ms; `flush` (a large buffer) is
    rewritten before each run so the weights come from device memory, as
    they do in decode."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def phase_kernels(torch, card: str):
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import int4_matmul as i4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows = {"int4": [], "flash": []}
    for k, n in INT4_SHAPES:
        q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8, device=dev)
        s = torch.rand((1, n), generator=g, device=dev) * 0.02 + 0.01
        for m in (1, 384):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            got = i4.int4_matmul(x, q4, s).float()
            want = i4.int4_matmul_plain(x, q4, s).float()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = cuda_ms(torch, lambda: i4.int4_matmul(x, q4, s), flush=flush)
            plain_ms = cuda_ms(torch, lambda: i4.int4_matmul_plain(x, q4, s), flush=flush)
            gbs = q4.numel() / (ms * 1e-3) / 1e9
            print(f"int4_matmul M={m} K={k} N={n}: rel_err={rel:.3e} abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms ({gbs:.0f} GB/s packed) plain {plain_ms:.4f} ms "
                  f"[{card}]", flush=True)
            check(rel <= INT4_TOL, f"int4_matmul M={m} K={k} N={n} rel err {rel} > {INT4_TOL}")
            rows["int4"].append((err, rel, ms, plain_ms))

    b, d = 1, 128
    cases = [  # name, S, T, N, KH, q_offset, valid slots
        ("prefill", 384, 512, 32, 32, 0, 305),
        ("cached-chunk", 64, 512, 32, 32, 128, 192),
        ("gqa", 384, 512, 32, 8, 0, 305),
    ]
    for name, s_len, t_len, nh, kh, off, n_valid in cases:
        q = torch.randn((b, s_len, nh, d), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, t_len, kh, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, t_len, kh, d), generator=g, device=dev).to(torch.bfloat16)
        mask = torch.zeros((b, t_len), dtype=torch.bool, device=dev)
        mask[:, :n_valid] = True
        got = fa.flash_attention(q, k, v, kv_mask=mask, q_offset=off).float()
        want = fa.flash_attention_plain(q, k, v, kv_mask=mask, q_offset=off).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, kv_mask=mask, q_offset=off))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, kv_mask=mask,
                                                                   q_offset=off))
        print(f"flash_attention {name} S={s_len} T={t_len} N={nh} K={kh} D={d} "
              f"q_offset={off}: abs_err={err:.3e} rel_err={rel:.3e} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms [{card}]", flush=True)
        check(err <= FLASH_TOL, f"flash_attention {name} abs err {err} > {FLASH_TOL}")
        rows["flash"].append((err, rel, ms, plain_ms))
    del flush
    return rows


def random_int4_llm(torch, params, gen, device, scale=None):
    """Replace the 7 projections and lm_head with random packed int4: bytes
    uniform in [-128, 128), as the JAX package's bench makes them. scale
    None gives each weight the init's std 1/sqrt(fan_in) (a uniform nibble
    has std 4.61); the bench's fixed 2e-2 is ~6x that at Vicuna-7B width."""
    llm = params["llm"]

    def qw(w):
        packed = tuple(w.shape[:-2]) + (w.shape[-2] // 2, w.shape[-1])
        s = scale if scale is not None else 1.0 / (4.61 * w.shape[-2] ** 0.5)
        return {"q4": torch.randint(-128, 128, packed, generator=gen, dtype=torch.int8,
                                    device=device),
                "s": torch.full(tuple(w.shape[:-2]) + (1, w.shape[-1]), s,
                                dtype=torch.float32, device=device)}

    for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
        llm["layers"][t] = qw(llm["layers"][t])
    llm["lm_head"] = qw(llm["lm_head"])
    return params


def build_system(torch, cfg, device, seed: int, int4_scale=None):
    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.system import VitronSystem

    gen = torch.Generator(device=device).manual_seed(seed)
    params = random_int4_llm(torch, vitron_model.init_params(gen, cfg, device), gen, device,
                             int4_scale)
    torch.cuda.empty_cache()
    return VitronSystem(VitronEngine(params, cfg, DemoTokenizer(), device=device)), params


def timed_chat(torch, system, image, sampling):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.chat(PROMPT, image=image, region_box=BBOX, sampling=sampling)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_slice(torch, card: str):
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import int4_matmul as i4
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.runtime.generation import SamplingConfig

    dev = torch.device("cuda")
    cfg = VitronConfig.serving(llm=LlamaConfig.vicuna_7b(attn_impl="flash", max_seq_len=1024))
    t0 = time.perf_counter()
    system, params = build_system(torch, cfg, dev, seed=0, int4_scale=2e-2)
    torch.cuda.synchronize()
    print(f"slice: Vicuna-7B int4 + ViT-L/14 bf16 random weights built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    sampling = SamplingConfig(greedy=True, max_new_tokens=NEW_TOKENS, eos_ids=())
    timed_chat(torch, system, image, sampling)  # warm-up (library handles, allocator)

    torch.cuda.reset_peak_memory_stats()
    i4.launches = 0
    fa.launches = 0
    out1, t_req = timed_chat(torch, system, image, sampling)
    launches = {"int4_matmul": i4.launches, "flash_attention": fa.launches}
    peak = torch.cuda.max_memory_allocated()
    gen_ = system.engine.generator
    logits = gen_.last_prefill_logits
    tokens1 = out1["reply"]["tokens"]
    n_layers = cfg.llm.num_layers
    per_forward = 7 * n_layers + 1
    print(f"slice: status={out1['status']} tokens={len(tokens1)} prefill logits "
          f"{tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())} "
          f"launches={launches}", flush=True)
    check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    check(len(tokens1) == NEW_TOKENS, f"{len(tokens1)} tokens, expected {NEW_TOKENS}")
    check(launches["int4_matmul"] == per_forward * NEW_TOKENS,
          f"int4_matmul launches {launches['int4_matmul']} != {per_forward} x {NEW_TOKENS} "
          "(prefill + one per decode step)")
    check(launches["flash_attention"] == n_layers,
          f"flash_attention launches {launches['flash_attention']} != {n_layers} (prefill)")

    out2, _ = timed_chat(torch, system, image, sampling)
    check(out2["reply"]["tokens"] == tokens1, "a second identical request gave other tokens")
    _, t_prefill = timed_chat(torch, system, image,
                              SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=()))
    decode_tok_s = (NEW_TOKENS - 1) / (t_req - t_prefill)
    weight_bytes = sum(leaf["q4"].numel() + leaf["s"].numel() * 4
                       for leaf in list(params["llm"]["layers"].values()) +
                       [params["llm"]["lm_head"]] if isinstance(leaf, dict))
    print(f"slice: request {t_req:.3f} s (128 tokens, same tokens twice), prefill request "
          f"(1 token) {t_prefill:.3f} s, decode {decode_tok_s:.1f} tok/s "
          f"({weight_bytes * decode_tok_s / HBM_BYTES_PER_S:.3f} of the 3.35 TB/s weight-"
          f"stream roofline), peak memory {peak / 2**30:.2f} GiB [{card}]", flush=True)
    del system, params, gen_, logits
    torch.cuda.empty_cache()
    return launches


def phase_cpu_vs_card(torch, card: str):
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.generation import SamplingConfig
    from vitron_tpu_torch.runtime.system import VitronSystem
    from vitron_tpu_torch.apps.cli import DemoTokenizer

    f32 = torch.float32
    cfg = VitronConfig(
        llm=LlamaConfig.vicuna_7b(num_layers=2, attn_impl="flash", max_seq_len=1024,
                                  param_dtype=f32, compute_dtype=f32),
        image_tower=ViTConfig.clip_vit_l14(), video_tower=ViTConfig.video_vit_l14())
    dev = torch.device("cuda")
    # init-scale int4 weights: at the bench's 2e-2 the random net is chaotic
    # (a 1e-6 relative nudge of one input moved the logits by 8e-3 relative
    # on the CPU), so no two summation orders could agree to 1e-3 there
    _, params = build_system(torch, cfg, dev, seed=5)

    def to_cpu(tree):
        return {k: to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cpu()

    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    one = SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=())
    logits = {}
    for name, device, p in (("cuda", dev, params), ("cpu", torch.device("cpu"), to_cpu(params))):
        engine = VitronEngine(p, cfg, DemoTokenizer(), device=device)
        t0 = time.perf_counter()
        VitronSystem(engine).chat(PROMPT, image=image, region_box=BBOX, sampling=one)
        logits[name] = engine.generator.last_prefill_logits.float().cpu()
        print(f"cpu-vs-card: {name} prefill {time.perf_counter() - t0:.1f} s", flush=True)
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    rel = err / logits["cpu"].abs().max().item()
    same = bool((logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).all())
    print(f"cpu-vs-card: 2-layer full-width float32 prefill, last-position logits rel_err="
          f"{rel:.3e} same_argmax={same} [{card}]", flush=True)
    check(rel <= CPU_GPU_TOL and same, f"CPU and card disagree: rel {rel}, same argmax {same}")


def main() -> int:
    card = nvidia_smi_line()
    print(card, flush=True)
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from vitron_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.lib()
    how = (f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds is not None
           else "already built")
    print(f"build: {path} ({how}; {time.perf_counter() - t0:.1f} s in all)", flush=True)

    with torch.no_grad():
        rows = phase_kernels(torch, card)
        launches = phase_slice(torch, card)
        phase_cpu_vs_card(torch, card)

    def entry(name, source, replaces, key):
        r = rows[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": max(x[0] for x in r),
                "max_rel_err": max(x[1] for x in r), "ms": sum(x[2] for x in r),
                "plain_ms": sum(x[3] for x in r),
                "ms_is": f"sum over the {len(r)} main-path shapes above"}

    print(json.dumps({"kernels": [
        entry("int4_matmul", "vitron_tpu_torch/csrc/int4_matmul.cu",
              "vitron_tpu/kernels/int4_matmul.py:108", "int4"),
        entry("flash_attention", "vitron_tpu_torch/csrc/flash_attention_fwd.cu",
              "vitron_tpu/kernels/flash_attention.py:242", "flash"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
