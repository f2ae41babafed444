#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vitron_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no `ok` line):
1. device: the `nvidia-smi` name and power limit; exit 1 without CUDA;
   TF32 off for matmuls and cuDNN, deterministic cuDNN algorithms.
2. build: the hand CUDA kernels from `vitron_tpu_torch/csrc/` (one nvcc per
   source, all started together, sm_90a).
3. kernel vs plain at the chat path's shapes: int4_matmul (bf16 x, M in
   {1, 384}, the four Vicuna-7B (K, N) pairs) and flash_attention (bf16,
   D = 128: masked prefill, cached chunk, GQA); error and CUDA-event times.
4. kernel vs plain at the GLIGEN path's shapes: flash_attention (bf16,
   non-causal, shift 0, D 40/80/512 with the ragged fuser lengths),
   geglu_ff (the four UNet sites, float32 and bf16), group_norm_sums (two
   UNet sites, the VAE's full resolution and the SEEM pixel decoder's four
   levels, float32 and bf16; also run twice for identical bits; device
   times from CUDA-graph replay, beside torch.var_mean).
5. kernel vs plain at FocalNet-L's shapes: depthwise_conv2d (the 16
   (stage, k) sites at 512^2 and a ragged shape, float32 and bf16), device
   times from CUDA-graph replay, beside F.conv2d(groups=C).
5b. kernel vs plain at the task-D path's shapes, float32 and bf16, at the
   four (N, C, heads) levels of the t2v block plan (2 x 24 frames):
   temporal_conv_k3 (beside cuDNN's F.conv2d with a (3, 1) filter),
   frame_attention (beside scaled_dot_product_attention on [B N, H, F, D]),
   geglu_ff at C 512/1024/2048, group_norm_sums at every [B, R, C] that
   one UNet call and the VAE decode of 24 frames give it (from the block
   plan and the VAE config; also run twice for identical bits), and
   flash_attention at the VAE decode's [24, 2880, 1, 512].
   Every kernel row of phases 3-5b prints its bound (bytes once at
   3.35 TB/s or FLOP at the peak for the type, whichever is larger) and,
   where one PyTorch call computes the same function, that call's time.
6. the chat slice at full width: VitronSystem.chat on Vicuna-7B with random
   packed-int4 projections and lm_head + bf16 ViT-L/14 tower, projector and
   region extractor; a 336x448 image, a bbox, 128 greedy tokens, twice;
   kernel launch counts, request / prefill / decode times, peak memory.
7. the chat path on the CPU and the card: a 2-layer full-width float32
   model, one prefill of the same request on both, last-position logits
   compared.
8. task B at full width: `SeemConfig()` registered with bf16 towers; text,
   stroke and 'segment all' replies routed by `VitronSystem.route` on a
   480x640 image, each twice (identical outputs, non-constant masks, and
   for 'segment all' identical, non-constant class and mask logits);
   depthwise and group-norm launches against the config (96 and 7 per
   encode_image); request times, peak memory; then a torch.profiler trace
   of a text request with ranges around encode_image and the decoder (host
   and kernel time of each, device busy and idle share, time by kernel).
9. task E at full width: a stroke tracked over 8 frames of 480x640, twice;
   9 encode_image's launches.
10. task A at full width: a fixed protocol reply routed to the port's
   `handle_a`: SD v1.4 GLIGEN UNet, SD VAE, CLIP-L text, float32, 512^2, 30
   grounding slots, 50 PLMS steps, guidance 7.5, alpha (0.3, 0, 0.7);
   twice (identical, non-constant images); launch counts of all three
   kernels against the block plan; request time, ms per CFG UNet call, VAE
   decode ms, peak memory.
11. task C at full width: the 9-channel inpainting UNet through handle_c's
   region branch, TASK_C_STEPS PLMS steps (fewer than A's 50, to save
   time), guidance 30; launch counts. Then through its SEEM branch: two
   ';'-separated phrases, no region, no sketch; 2 encode_image's launches
   plus GLIGEN's.
12. the bf16 CFG UNet step at bench.py's `bench_sd_unet` shape (SD v1.4, no
   grounding, bf16 params, [2, 64, 64, 4] latents, [2, 77, 768] context):
   `sd_unet_cfg_steps_per_s`.
13. the diffusion path on the CPU and the card: one full-width float32
   grounded CFG UNet call at reduced depth and latent size (one level,
   32x32 latents: four transformer blocks whose self-attention and fuser
   sites take the flash kernel on the card), compared with the CPU.
14. SEEM on the CPU and the card: one full-width float32 segment_text at
   reduced depth (FocalNet depths 1/1/1/1 with all four focal levels, 2
   encoder, decoder and language layers, 256^2): mask logits, the matched
   query and the flipped cross-attention-mask bits.
15. task D at full width: `Text2VideoConfig()` (UNetSD_T2V, SD VAE, CLIP
   text 1024 wide, float32, 24 frames at 320x576, guidance 9) with random
   weights (zero leaves filled), a fixed protocol reply routed to the port's
   `handle_d`, TASK_D_STEPS DDIM-v steps, twice: identical, finite,
   non-constant frames; launch counts of all five kernels against the block
   plan; request time, ms per CFG UNet call, VAE decode ms, peak memory.
16. the bf16 CFG video UNet step at bench.py's `bench_video_unet` shape
   ([2, 24, 40, 72, 4] latents, [2, 77, 1024] context):
   `video_unet_cfg_steps_per_s` and `video_unet_mfu` (the block plan's FLOP
   against 989 TFLOP/s).
17. the video path on the CPU and the card: one float32 CFG-batch t2v UNet
   call at the real widths but two levels (512/1024), 8 frames, 16x16
   latents.
The line before the last is a JSON object with one entry per kernel (with
its launches on each main path); the last line is {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import collections
import dataclasses
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
GEGLU_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|
GN_TOL = 1e-5  # max |kernel - plain| / max |plain|: float32 sums in two orders
# the diffusion CPU-vs-card check, max |card - cpu| / max |cpu|: with the
# flash sites on the einsum path on both sides only the order of float32 sums
# differs; with them on the kernel, q/k/v are rounded to bf16 (2^-9 relative)
# at the eight flash sites, which moves the eps by up to a few percent
UNET_CPU_GPU_TOL = {"einsum": 1e-3, "flash": 5e-2}
TASK_A_REPLY = ("<module>A</module><instruction>a red car on a street</instruction>"
                "<region>[0.1,0.2,0.6,0.8]</region>")
TASK_C_REPLY = ("<module>C</module><instruction>a green bus</instruction>"
                "<region>[0.25,0.1,0.75,0.6]</region>")
TASK_C_STEPS = 10
TASK_B_REPLY = "<module>B</module><instruction>the red car</instruction>"
TASK_B_PANOPTIC_REPLY = "<module>B</module><instruction></instruction>"
TASK_E_REPLY = "<module>E</module><instruction>track the red car</instruction>"
TASK_C_SEEM_REPLY = "<module>C</module><instruction>the red car; a dog</instruction>"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# peak rates of the bound (H100 SXM data sheet, dense, at 700 W): bf16 on the
# tensor cores for the bf16 matrix products, float32 on the CUDA cores for
# everything else (float32 products run in full float32: TF32 is off)
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12}
DW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}  # max |kernel - plain| / max |plain|
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


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one fn() in ms: `calls` calls captured in a CUDA graph
    and replayed, so the host's launch cost (~20-40 us a call from Python,
    more than a small kernel runs) stays out of the reading."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def row(err, rel, ms, plain_ms, nbytes, flops, peak, library_ms=None) -> dict:
    """One kernel-vs-plain measurement with its bound: the least time for
    `nbytes` (each input read once, each output written once) at 3.35 TB/s
    and for `flops` at the `peak` rate, whichever is larger."""
    return {"err": err, "rel": rel, "ms": ms, "plain_ms": plain_ms,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / PEAK_FLOPS[peak] * 1e3, "library_ms": library_ms}


def bound_text(r: dict) -> str:
    b = max(r["bytes_ms"], r["ops_ms"])
    by = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    return f"bound {b:.4f} ms ({by}), library {lib}"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tree_map(fn, tree):
    """fn applied to every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def sdpa_ms(torch, q, k, v, attn_mask=None) -> float:
    """CUDA-event time of F.scaled_dot_product_attention on the same
    [B, S, N, D] inputs (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, enable_gqa=gqa), iters=10)


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
            # no single PyTorch call takes this int4 packing: no library time
            r = row(err, rel, ms, plain_ms, nbytes(x, q4, s, got.to(torch.bfloat16)),
                    2 * m * k * n, "bf16_tensor")
            print(f"int4_matmul M={m} K={k} N={n}: rel_err={rel:.3e} abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms ({gbs:.0f} GB/s packed) plain {plain_ms:.4f} ms "
                  f"{bound_text(r)} [{card}]", flush=True)
            check(rel <= INT4_TOL, f"int4_matmul M={m} K={k} N={n} rel err {rel} > {INT4_TOL}")
            rows["int4"].append(r)

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
        visible = fa._visible(b, s_len, t_len, dev, mask, off, True)[:, 0, 0]  # [B, S, T]
        lib_ms = sdpa_ms(torch, q, k, v, visible[:, None])
        r = row(err, rel, ms, plain_ms, nbytes(q, k, v, mask, got.to(torch.bfloat16)),
                4 * d * nh * int(visible.sum()), "bf16_tensor", lib_ms)
        print(f"flash_attention {name} S={s_len} T={t_len} N={nh} K={kh} D={d} "
              f"q_offset={off}: abs_err={err:.3e} rel_err={rel:.3e} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check(err <= FLASH_TOL, f"flash_attention {name} abs err {err} > {FLASH_TOL}")
        rows["flash"].append(r)
    del flush
    return rows


def phase_diffusion_kernels(torch, card: str):
    """Each diffusion kernel against its plain version at the GLIGEN path's
    shapes, on the same inputs; CUDA-event times of both."""
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = {"flash_gligen": [], "geglu": [], "gn": []}
    bf16 = torch.bfloat16
    for b, s_len, heads, d in ((2, 4096, 8, 40), (2, 4126, 8, 40), (2, 1024, 8, 80),
                               (2, 1054, 8, 80), (1, 4096, 1, 512)):
        q, k, v = (torch.randn((b, s_len, heads, d), generator=g, device=dev).to(bf16)
                   for _ in range(3))
        call = dict(causal=False, softmax_shift=0.0)
        got = fa.flash_attention(q, k, v, **call).float()
        want = fa.flash_attention_plain(q, k, v, **call).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **call), iters=10)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **call), iters=10)
        flops = 4 * b * heads * s_len * s_len * d
        tflops = flops / (ms * 1e-3) / 1e12
        r = row(err, rel, ms, plain_ms, 4 * nbytes(q), flops, "bf16_tensor",
                sdpa_ms(torch, q, k, v))
        print(f"flash_attention gligen [{b},{s_len},{heads},{d}] bf16 non-causal shift 0: "
              f"abs_err={err:.3e} kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) plain "
              f"{plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check(err <= FLASH_TOL, f"flash_attention D={d} S={s_len} abs err {err} > {FLASH_TOL}")
        rows["flash_gligen"].append(r)
        del q, k, v, got, want

    for m, c in ((8192, 320), (2048, 640), (512, 1280), (128, 1280)):
        f = 4 * c
        x = torch.randn((m, c), generator=g, device=dev)
        w1 = torch.randn((c, 2 * f), generator=g, device=dev) / c ** 0.5
        b1 = 0.1 * torch.randn((2 * f,), generator=g, device=dev)
        w2 = torch.randn((f, c), generator=g, device=dev) / f ** 0.5
        b2 = 0.1 * torch.randn((c,), generator=g, device=dev)
        for dtype in (torch.float32, bf16):
            args = [a.to(dtype) for a in (x, w1, b1, w2, b2)]
            got = gf.geglu_ff(*args).float()
            want = gf.geglu_ff_plain(*args).float()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = cuda_ms(torch, lambda: gf.geglu_ff(*args))
            plain_ms = cuda_ms(torch, lambda: gf.geglu_ff_plain(*args))
            tflops = 24 * m * c * c / (ms * 1e-3) / 1e12
            name = str(dtype).split(".")[-1]
            # two products and a gelu: no single PyTorch call, no library time
            r = row(err, rel, ms, plain_ms, nbytes(*args) + nbytes(got.to(dtype)),
                    6 * m * c * f, "bf16_tensor" if dtype == bf16 else "fp32")
            print(f"geglu_ff M={m} C={c} F={f} {name}: rel_err={rel:.3e} abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {plain_ms:.4f} ms "
                  f"{bound_text(r)} [{card}]", flush=True)
            check(rel <= GEGLU_TOL[name], f"geglu_ff M={m} C={c} {name} rel err {rel}")
            rows["geglu"].append(r)

    for shape in GN_SHAPES:
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        for dtype in (torch.float32, bf16):
            x = x32.to(dtype)
            got = gn.group_norm_sums(x)
            again = gn.group_norm_sums(x)
            want = gn.group_norm_sums_plain(x)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = graph_ms(torch, lambda: gn.group_norm_sums(x))
            plain_ms = graph_ms(torch, lambda: gn.group_norm_sums_plain(x))
            # the same per-channel statistics in one call: sum = R mean,
            # sum of squares = R (var + mean^2)
            lib_ms = graph_ms(torch, lambda: torch.var_mean(x, dim=1, correction=0))
            gbs = x.numel() * x.element_size() / (ms * 1e-3) / 1e9
            name = str(dtype).split(".")[-1]
            r = row(err, rel, ms, plain_ms, nbytes(x, got), 3 * x.numel(), "fp32", lib_ms)
            print(f"group_norm_sums {list(shape)} {name}: rel_err={rel:.3e} kernel {ms:.4f} ms "
                  f"({gbs:.0f} GB/s) plain {plain_ms:.4f} ms, same bits twice="
                  f"{bool(torch.equal(got, again))} {bound_text(r)} (graph-replayed device "
                  f"times) [{card}]", flush=True)
            check(rel <= GN_TOL, f"group_norm_sums {shape} {name} rel err {rel} > {GN_TOL}")
            check(bool(torch.equal(got, again)), f"group_norm_sums {shape} not deterministic")
            rows["gn"].append(r)
    return rows


# group-norm sums [B, R, C]: two UNet sites, the VAE at full resolution, and
# the SEEM pixel decoder's four levels at 512^2 (res5 to res2, conv_dim 512)
GN_SHAPES = ((2, 4096, 320), (2, 1024, 640), (1, 262144, 128),
             (1, 256, 512), (1, 1024, 512), (1, 4096, 512), (1, 16384, 512))
# FocalNet-L at the served 512x512 input: (x shape, k) of every depthwise
# site (stage i has 2/2/18/2 blocks, each k = 3/5/7/9) and a ragged shape
DW_SHAPES = ([((1, 128 >> i, 128 >> i, 192 << i), k) for i in range(4) for k in (3, 5, 7, 9)]
             + [((2, 37, 53, 200), 5)])


def phase_seem_kernels(torch, card: str):
    """The depthwise kernel against its plain version at FocalNet-L's shapes,
    float32 and bf16; CUDA-event times of the kernel, the plain version and
    F.conv2d(groups=C) on the channels-last view (the library yardstick)."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import depthwise_conv as dw

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {"dw": []}
    for shape, k in DW_SHAPES:
        c = shape[-1]
        x32 = torch.randn(shape, generator=g, device=dev)
        w32 = torch.randn((k, k, c), generator=g, device=dev) / k
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            got = dw.depthwise_conv2d(x, w)
            want = dw.depthwise_conv2d_plain(x, w)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            ms = graph_ms(torch, lambda: dw.depthwise_conv2d(x, w))
            plain_ms = graph_ms(torch, lambda: dw.depthwise_conv2d_plain(x, w), calls=2)
            xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor: channels_last
            wc = w.permute(2, 0, 1)[:, None].contiguous()
            lib_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, padding=k // 2, groups=c))
            name = str(dtype).split(".")[-1]
            r = row(err, rel, ms, plain_ms, nbytes(x, w, got), 2 * k * k * x.numel(), "fp32",
                    lib_ms)
            print(f"depthwise_conv2d {list(shape)} k={k} {name}: abs_err={err:.3e} "
                  f"rel_err={rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms {bound_text(r)} (graph-replayed device times) "
                  f"[{card}]", flush=True)
            check(rel <= DW_TOL[name], f"depthwise_conv2d {shape} k={k} {name} rel err {rel}")
            rows["dw"].append(r)
    return rows


def seem_counts(cfg) -> dict:
    """Kernel launches of one SEEM encode_image, from the config: the
    depthwise kernel at every focal level of every FocalNet block, group norm
    at res5's output and at the lateral and output of each lower level."""
    return {"depthwise_conv2d": sum(d * l for d, l in zip(cfg.backbone.depths,
                                                          cfg.backbone.focal_levels)),
            "group_norm_sums": 2 * len(cfg.pixel.in_channels) - 1}


def seem_kernels():
    from vitron_tpu_torch.kernels import depthwise_conv as dw
    from vitron_tpu_torch.kernels import group_norm as gn

    return {"depthwise_conv2d": dw, "group_norm_sums": gn}


def build_seem_params(torch, cfg, device, seed: int):
    """SEEM params from a seed, every all-zero leaf (biases, logit_scale)
    filled as for GLIGEN and the FocalNet layerscale gammas drawn from
    U(0.5, 1.5): at their 1e-4 init a block's output falls below bf16's
    resolution against the residual, and the depthwise kernel's output would
    not reach the masks."""
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
    from vitron_tpu_torch.models.seem import model as seem_model

    g = torch.Generator(device=device).manual_seed(seed)
    params = fill_zero_leaves(seem_model.init_params(g, cfg, device), g)
    for stage in params["backbone"]["stages"]:
        for blk in stage["blocks"]:
            for key in ("gamma_1", "gamma_2"):
                blk[key] = 0.5 + torch.rand(blk[key].shape, generator=g, device=device)
    return params


def seem_system(torch, cfg, params, pipe=None):
    """A VitronSystem serving SEEM as registered for deployment (bf16
    backbone and pixel decoder), with GLIGEN beside it when given."""
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer
    from vitron_tpu_torch.runtime.system import VitronSystem

    system = VitronSystem(None)
    system.register_seem(params, cfg, StubClipTokenizer(cfg.lang.vocab_size),
                         compute_dtype="bfloat16")
    if pipe is not None:
        system.register_gligen(pipe)
    return system


def stroke_mask(h: int, w: int) -> np.ndarray:
    m = np.zeros((h, w), bool)
    m[h * 3 // 10: h * 7 // 10, w * 3 // 10: w * 2 // 3] = True
    return m


def phase_task_b(torch, card: str, system, cfg):
    """Text, stroke and 'segment all' through VitronSystem.route, each twice
    (identical outputs), with the depthwise and group-norm launches of one
    encode_image per request. 'Segment all' is also held on what the model
    computes before the host thresholds it: segment_panoptic's class and
    mask logits, identical twice and non-constant (random weights leave
    every class score under panoptic_inference's 0.8, so no segment is
    kept)."""
    from vitron_tpu_torch.models.seem import model as seem_model

    per = seem_counts(cfg)
    kernels = seem_kernels()
    image = np.random.RandomState(3).randint(0, 256, (480, 640, 3), np.uint8)
    sketch = stroke_mask(480, 640)
    total = {name: 0 for name in kernels}
    logits = []
    segment_panoptic = seem_model.segment_panoptic

    def recorded_panoptic(*args, **kw):
        out = segment_panoptic(*args, **kw)
        logits.append(tuple(t.cpu() for t in out))
        return out

    torch.cuda.reset_peak_memory_stats()
    seem_model.segment_panoptic = recorded_panoptic
    try:
        for name, reply, sk in (("text", TASK_B_REPLY, None), ("stroke", TASK_B_REPLY, sketch),
                                ("panoptic", TASK_B_PANOPTIC_REPLY, None)):
            outs = []
            for i in range(2):
                for mod in kernels.values():
                    mod.launches = 0
                out, t_req = timed_route(torch, system, reply, image=image, sketch_mask=sk)
                got = expect_launches(kernels, per, f"task B {name} run {i + 1}")
                total = {k: total[k] + got[k] for k in total}
                check(out["status"] == "ok" and out["task"] == "image_segmentation",
                      f"task B {name}: status {out['status']}, {out.get('error')}")
                if name == "panoptic":
                    res = out["panoptic"]
                    cls, masks = logits[-1]
                    what = (f"{len(out['segments'])} segments, class logits {tuple(cls.shape)} "
                            f"std {cls.std():.4f}, mask logits {tuple(masks.shape)} std "
                            f"{masks.std():.4f}")
                    check(res.shape == (480, 640) and cls.std() > 0 and masks.std() > 0,
                          "task B panoptic: constant class or mask logits")
                else:
                    res = out["mask"]
                    what = f"mask {res.shape} covers {res.mean():.3f}"
                    check(res.shape == (480, 640) and bool(res.any()) and not bool(res.all()),
                          f"task B {name}: the mask is constant")
                outs.append((res, out["overlay"]))
                print(f"task B {name} run {i + 1}: request {t_req:.3f} s, {what} [{card}]",
                      flush=True)
            check(all(np.array_equal(a, b) for a, b in zip(*outs)),
                  f"task B {name}: two identical requests gave other outputs")
    finally:
        seem_model.segment_panoptic = segment_panoptic
    check(len(logits) == 2 and all(torch.equal(a, b) for a, b in zip(*logits)),
          "task B panoptic: two identical requests gave other class or mask logits")
    print(f"task B: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    return total


def seem_breakdown(torch, card: str, system, image):
    """Where a task-B text request's time goes: a torch.profiler trace of the
    routed request with a range around encode_image and one around the SEEM
    decoder. Each range's host time and the device time of the kernels it
    launched; the device time summed by kernel gives the device's busy
    share of the unprofiled request."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from vitron_tpu_torch.models.seem import decoder as dec
    from vitron_tpu_torch.models.seem import model as seem_model

    spans = {"seem.encode_image": (seem_model, "encode_image"), "seem.decoder": (dec, "forward")}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in spans.items()}

    def ranged(name):
        def call(*args, **kw):
            with record_function(name):
                return saved[name](*args, **kw)
        return call

    _, t_req = timed_route(torch, system, TASK_B_REPLY, image=image)
    for name, (mod, attr) in spans.items():
        setattr(mod, attr, ranged(name))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, t_prof = timed_route(torch, system, TASK_B_REPLY, image=image)
    finally:
        for name, (mod, attr) in spans.items():
            setattr(mod, attr, saved[name])
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    # the ranges also appear on the device timeline: not kernels
    kernels = [e for e in events if e.device_type == cuda and e.key not in spans]
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    busy = sum(dev_ms.values())
    dw_ms = sum(v for k, v in dev_ms.items() if "dw_kernel" in k)
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    ranges = []
    for name in spans:
        e = next((e for e in events if e.key == name and e.device_type != cuda), None)
        check(e is not None, f"task B breakdown: no '{name}' range in the trace")
        ranges.append(f"{name} host {e.cpu_time_total / 1e3:.2f} ms, its kernels "
                      f"{e.device_time_total / 1e3:.2f} ms")
    print(f"task B breakdown: text request {t_req * 1e3:.1f} ms unprofiled, "
          f"{t_prof * 1e3:.1f} ms profiled; {'; '.join(ranges)} (profiled, bf16 towers, "
          f"512^2); device busy {busy:.2f} ms = {busy / (t_req * 1e3):.3f} of the unprofiled "
          f"request (idle share {1 - busy / (t_req * 1e3):.3f}); depthwise kernel "
          f"{dw_ms:.3f} ms in {sum(e.count for e in kernels if 'dw_kernel' in e.key)} "
          f"launches [{card}]", flush=True)
    print("task B device time by kernel (ms): " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top),
          flush=True)


def phase_task_e(torch, card: str, system, cfg, frames: int = 8):
    """Video tracking of a stroke over `frames` 480x640 frames (1.6 s at the
    reference's 5 fps), twice: one encode_image per frame plus the reference
    frame's."""
    per = seem_counts(cfg)
    want = {k: (frames + 1) * v for k, v in per.items()}
    kernels = seem_kernels()
    video = np.random.RandomState(4).randint(0, 256, (frames, 480, 640, 3), np.uint8)
    runs = []
    for i in range(2):
        for mod in kernels.values():
            mod.launches = 0
        out, t_req = timed_route(torch, system, TASK_E_REPLY, video=video,
                                 sketch_mask=stroke_mask(480, 640))
        launches = expect_launches(kernels, want, f"task E run {i + 1}")
        check(out["status"] == "ok" and out["task"] == "video_tracking",
              f"task E: status {out['status']}, {out.get('error')}")
        masks = out["masks"]
        side = cfg.input_size // 4
        check(masks.shape == (frames, side, side) and out["overlay_frames"].shape ==
              (frames, 480, 640, 3), f"task E shapes {masks.shape}")
        check(bool(masks.any()) and not bool(masks.all()), "task E: the masks are constant")
        runs.append(masks)
        print(f"task E run {i + 1}: {frames} frames 480x640, request {t_req:.3f} s "
              f"({t_req / frames * 1e3:.1f} ms per frame), masks cover {masks.mean():.3f} "
              f"[{card}]", flush=True)
    check(np.array_equal(runs[0], runs[1]), "task E: two identical requests gave other masks")
    return launches


def phase_task_c_seem(torch, card: str, pipe, seem_params, cfg):
    """C with two ';'-separated phrases and neither a region nor a sketch:
    SEEM segments each phrase (two encode_image), then the 9-channel GLIGEN
    inpaint at TASK_C_STEPS steps."""
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenPipeline
    gcfg = dataclasses.replace(pipe.cfg, steps=TASK_C_STEPS)
    short = GligenPipeline(gcfg, pipe.unet_params, pipe.vae_params, pipe.text_params,
                           inpaint_unet_params=pipe.inpaint_unet_params, tokenizer=pipe.tokenizer)
    system = seem_system(torch, cfg, seem_params, short)
    ucfg9 = dataclasses.replace(gcfg.unet, in_channels=9)
    unet = unet_counts(ucfg9, gcfg.latent_size, gcfg.max_objs, gcfg.text.max_length)
    enc, dec = vae_counts(gcfg.vae, gcfg.latent_size ** 2)
    want = {k: (gcfg.steps + 1) * unet[k] + enc[k] + dec[k] for k in unet}
    want["depthwise_conv2d"] = 0
    for k, v in seem_counts(cfg).items():
        want[k] += 2 * v
    kernels = {**diffusion_kernels(), **seem_kernels()}
    image = np.random.RandomState(5).randint(0, 256, (480, 640, 3), np.uint8)
    for mod in kernels.values():
        mod.launches = 0
    out, t_req = timed_route(torch, system, TASK_C_SEEM_REPLY, image=image)
    launches = expect_launches(kernels, want, "task C (SEEM branch)")
    img = out["image"]
    check(out["status"] == "ok" and out["task"] == "image_editing",
          f"task C (SEEM): status {out['status']}, {out.get('error')}")
    check(img.shape == (gcfg.image_size, gcfg.image_size, 3) and int(img.max()) != int(img.min()),
          f"task C (SEEM) image {img.shape}")
    print(f"task C (SEEM branch: 2 phrases segmented, {gcfg.steps} PLMS steps): request "
          f"{t_req:.3f} s, image mean {img.mean():.2f} std {img.std():.2f} [{card}]", flush=True)
    return launches


def phase_seem_cpu_vs_card(torch, card: str):
    """One full-width float32 segment_text at reduced depth (FocalNet depths
    1/1/1/1 with all four focal levels, 2 encoder, 2 decoder and 2 language
    layers, a 256x256 image) on the CPU and on the card: the mask logits, the
    matched query and the flipped cross-attention-mask bits."""
    from vitron_tpu_torch.models.seem import decoder as dec
    from vitron_tpu_torch.models.seem import focalnet, language, pixel_decoder
    from vitron_tpu_torch.models.seem import model as seem_model

    cfg = seem_model.SeemConfig(
        backbone=focalnet.FocalNetConfig.focall(depths=(1, 1, 1, 1)),
        pixel=pixel_decoder.PixelDecoderConfig(num_enc_layers=2),
        decoder=dec.SeemDecoderConfig(dec_layers=2), lang=language.LangConfig(num_layers=2),
        input_size=256)
    cpu = torch.device("cpu")
    params = build_seem_params(torch, cfg, cpu, seed=8)
    image = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (256, 256, 3), np.uint8))
    ids = np.zeros((1, cfg.lang.context_length), np.int64)
    ids[0, :5] = [49406, 320, 736, 1615, 49407]
    ids = torch.from_numpy(ids)
    decoded = []
    forward = dec.forward

    def recorded_forward(*args, **kw):  # keeps the decoder output to find the match
        decoded.append(forward(*args, **kw))
        return decoded[-1]

    res = {}
    dec.forward = recorded_forward
    try:
        for name, device in (("cpu", cpu), ("cuda", torch.device("cuda"))):
            p = params if device == cpu else tree_map(lambda a: a.to(device), params)
            t0 = time.perf_counter()
            with dec.recording_attn_masks() as masks:
                mask, _ = seem_model.segment_text(p, cfg, image.to(device), ids.to(device),
                                                  (ids != 0).to(device))
            pred = decoded[-1]["pred_masks"][0]
            matched = [q for q in range(pred.shape[0]) if torch.equal(pred[q], mask)]
            res[name] = (mask.float().cpu(), [m.cpu() for m in masks], matched)
            print(f"seem cpu-vs-card: {name} segment_text {time.perf_counter() - t0:.1f} s, "
                  f"matched query {matched}", flush=True)
    finally:
        dec.forward = forward
    (m_cpu, a_cpu, q_cpu), (m_gpu, a_gpu, q_gpu) = res["cpu"], res["cuda"]
    rel = (m_gpu - m_cpu).abs().max().item() / m_cpu.abs().max().item()
    flips = sum(int((a != b).sum()) for a, b in zip(a_cpu, a_gpu))
    print(f"seem cpu-vs-card: full-width float32 segment_text (depth 1/1/1/1, 256x256): mask "
          f"logits rel_err={rel:.3e} (limit {CPU_GPU_TOL}), matched query {q_cpu} / {q_gpu}, "
          f"attention-mask bits flipped {flips} of {sum(a.numel() for a in a_cpu)} [{card}]",
          flush=True)
    check(len(q_cpu) == 1 and q_cpu == q_gpu, f"SEEM CPU and card match other queries: "
          f"{q_cpu} / {q_gpu}")
    check(rel <= CPU_GPU_TOL, f"SEEM CPU and card disagree: rel {rel}")


def unet_counts(ucfg, latent: int, n_objs: int, n_ctx: int) -> dict:
    """Kernel launches of one UNet call, from the block plan: flash at every
    attention site (self, fuser with n_objs grounding tokens, cross with
    n_ctx context tokens) whose query and key lengths reach
    VITRON_FLASH_MIN, GEGLU in every block and fuser, group norm twice per
    ResNet, once per spatial transformer and once at the output."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min
    from vitron_tpu_torch.models.diffusion.unet2d import block_plan

    fmin = _flash_min()
    counts = {"flash_attention": 0, "geglu_ff": 0, "group_norm_sums": 1}
    size = latent
    input_plan, middle_plan, output_plan = block_plan(ucfg)
    for entries in input_plan + [middle_plan] + output_plan:
        for e in entries:
            size = size // 2 if e[0] == "down" else size * 2 if e[0] == "up" else size
            if e[0] == "res":
                counts["group_norm_sums"] += 2
            elif e[0] == "attn":
                counts["group_norm_sums"] += 1
                n = size * size
                per_block = (int(n >= fmin) + int(n_objs > 0 and n + n_objs >= fmin)
                             + int(n >= fmin and n_ctx >= fmin))
                counts["flash_attention"] += ucfg.transformer_depth * per_block
                counts["geglu_ff"] += ucfg.transformer_depth * (1 + int(n_objs > 0))
    return counts


def vae_counts(vcfg, pixels: int):
    """(encode, decode) kernel launches: group norm twice per ResNet, once in
    the mid attention, once at the output; flash in the mid attention, which
    runs at the latent's `pixels`."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    levels = len(vcfg.channel_mult)
    flash = int(pixels >= _flash_min())
    enc = {"flash_attention": flash, "geglu_ff": 0,
           "group_norm_sums": 2 * (levels * vcfg.num_res_blocks + 2) + 2}
    dec = {"flash_attention": flash, "geglu_ff": 0,
           "group_norm_sums": 2 * (levels * (vcfg.num_res_blocks + 1) + 2) + 2}
    return enc, dec


def video_plan(ucfg, lh: int, lw: int):
    """(entry, latent pixels at that entry) for every entry of the video
    UNet's block plan at an lh x lw latent."""
    from vitron_tpu_torch.models.diffusion.unet_sd_video import block_plan

    h, w = lh, lw
    input_plan, middle_plan, output_plan = block_plan(ucfg)
    for entries in input_plan + [middle_plan] + output_plan:
        for e in entries:
            if e[0] == "down":
                h, w = (h + 1) // 2, (w + 1) // 2
            yield e, h * w
            if e[0] == "up":
                h, w = 2 * h, 2 * w


def video_sites(ucfg, lh: int, lw: int):
    """(pixels N, width C, heads) of each temporal-transformer level, widest
    first: where B6 (the res blocks' Co), B7 and B3 run."""
    return sorted({(n, e[1], e[2]) for e, n in video_plan(ucfg, lh, lw) if e[0] == "tattn"},
                  reverse=True)


def video_counts(ucfg, lh: int, lw: int, n_ctx: int) -> dict:
    """Kernel launches of one video UNet call, from the block plan: four
    temporal convs and six group norms per res block (two of its own, four
    in its temporal conv block), two frame attentions per temporal
    transformer, GEGLU and one group norm in every transformer, flash at a
    spatial site whose query and key lengths reach VITRON_FLASH_MIN, and the
    output group norm."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    fmin = _flash_min()
    counts = {"temporal_conv_k3": 0, "frame_attention": 0, "geglu_ff": 0,
              "group_norm_sums": 1, "flash_attention": 0}
    for e, n in video_plan(ucfg, lh, lw):
        if e[0] == "res":
            counts["temporal_conv_k3"] += 4
            counts["group_norm_sums"] += 6
        elif e[0] in ("sattn", "tattn"):
            counts["group_norm_sums"] += 1
            counts["geglu_ff"] += 1
            if e[0] == "tattn":
                counts["frame_attention"] += 2
            else:
                counts["flash_attention"] += int(n >= fmin) + int(n >= fmin and n_ctx >= fmin)
    return counts


def video_gn_shapes(ucfg, lh: int, lw: int, batch: int, frames: int) -> collections.Counter:
    """[B, R, C] of every group-norm-sums launch of one video UNet call, with
    its count, from the block plan: a res block's norm1 [B F, N, cin] and
    norm2 [B F, N, cout] and its temporal conv block's four [B, F N, cout],
    a spatial transformer's [B F, N, C], a temporal one's [B, F N, C], and
    the output norm [B F, lh lw, dim]."""
    bf = batch * frames
    shapes = collections.Counter({(bf, lh * lw, ucfg.dim): 1})
    for e, n in video_plan(ucfg, lh, lw):
        if e[0] == "res":
            shapes[(bf, n, e[1])] += 1
            shapes[(bf, n, e[2])] += 1
            shapes[(batch, frames * n, e[2])] += 4
        elif e[0] == "sattn":
            shapes[(bf, n, e[1])] += 1
        elif e[0] == "tattn":
            shapes[(batch, frames * n, e[1])] += 1
    return shapes


def vae_decode_gn_shapes(vcfg, lh: int, lw: int, batch: int) -> collections.Counter:
    """[B, R, C] of every group-norm-sums launch of one VAE decode of
    [batch, lh, lw, z] latents, with its count: the mid ResNets' four and the
    mid attention's one at the top width, each level's ResNets (norm1 at
    their input width, norm2 at their output width, 4x the rows after each
    upsampling), and the output norm."""
    bc = vcfg.base_channels
    ch, rows = vcfg.channel_mult[-1] * bc, lh * lw
    shapes = collections.Counter({(batch, rows, ch): 5})
    for li, mult in reversed(list(enumerate(vcfg.channel_mult))):
        for _ in range(vcfg.num_res_blocks + 1):
            shapes[(batch, rows, ch)] += 1
            ch = mult * bc
            shapes[(batch, rows, ch)] += 1
        if li != 0:
            rows *= 4
    shapes[(batch, rows, bc)] += 1
    return shapes


def video_unet_flops(ucfg, lh: int, lw: int, frames: int, batch: int, n_ctx: int) -> int:
    """Multiply-add FLOP (2 per MAC) of one video UNet call, from the block
    plan: every conv, projection, feed-forward, temporal conv and attention
    product (norms and elementwise work left out)."""
    bf = batch * frames
    flops = 2 * 9 * ucfg.dim * ucfg.out_dim * bf * lh * lw  # the out conv
    for e, n in video_plan(ucfg, lh, lw):
        m = bf * n
        if e[0] == "conv_in":
            flops += 2 * 9 * e[1] * e[2] * m
        elif e[0] == "res":
            cin, cout = e[1], e[2]
            flops += 2 * 9 * (cin + cout) * cout * m + 2 * batch * ucfg.embed_dim * cout
            flops += 2 * cin * cout * m if cin != cout else 0
            flops += 4 * 2 * 3 * cout * cout * m  # the temporal conv block
        elif e[0] in ("sattn", "tattn"):
            ch, inner = e[1], (e[3] if e[0] == "tattn" else e[1])
            flops += 2 * 2 * m * ch * inner + 24 * m * inner * inner  # proj in/out, GEGLU
            if e[0] == "tattn":  # two frame self-attentions
                flops += 2 * (4 * 2 * m * inner * inner + 2 * 2 * batch * n * frames ** 2 * inner)
            else:  # self-attention over n tokens, cross-attention to n_ctx
                flops += 4 * 2 * m * inner * inner + 2 * 2 * bf * n * n * inner
                flops += 2 * 2 * m * inner * inner + 2 * 2 * bf * n_ctx * ucfg.context_dim * inner
                flops += 2 * 2 * bf * n * n_ctx * inner
        elif e[0] == "down":
            flops += 2 * 9 * e[1] * e[1] * m
        elif e[0] == "up":
            flops += 2 * 9 * e[1] * e[1] * 4 * m
    return flops


def diffusion_kernels():
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn

    return {"flash_attention": fa, "geglu_ff": gf, "group_norm_sums": gn}


def build_gligen(torch, cfg, device, seed: int):
    """GLIGEN pipeline (float32, random weights with every zero leaf filled)
    plus the 9-channel inpainting UNet."""
    from vitron_tpu_torch.models.diffusion import clip_text, unet2d, vae
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenPipeline
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves

    g = torch.Generator(device=device).manual_seed(seed)
    unet = fill_zero_leaves(unet2d.init_params(g, cfg.unet, device), g)
    unet9 = fill_zero_leaves(unet2d.init_params(
        g, dataclasses.replace(cfg.unet, in_channels=9), device), g)
    vae_p = fill_zero_leaves(vae.init_params(g, cfg.vae, device), g)
    text = fill_zero_leaves(clip_text.init_params(g, cfg.text, device), g)
    return GligenPipeline(cfg, unet, vae_p, text, inpaint_unet_params=unet9,
                          tokenizer=StubClipTokenizer(cfg.text.vocab_size))


def timed_route(torch, system, reply, **media):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.route(reply, **media)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def expect_launches(kernels, want: dict, what: str) -> dict:
    got = {name: mod.launches for name, mod in kernels.items()}
    print(f"{what}: launches {got} (expected {want})", flush=True)
    check(got == want, f"{what}: kernel launches {got} != {want}")
    return got


def phase_task_a(torch, card: str, pipe):
    from vitron_tpu_torch.models.diffusion import vae
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = pipe.cfg
    system = VitronSystem(None)
    system.register_gligen(pipe)
    unet = unet_counts(cfg.unet, cfg.latent_size, cfg.max_objs, cfg.text.max_length)
    _, dec = vae_counts(cfg.vae, cfg.latent_size ** 2)
    calls = cfg.steps + 1  # PLMS: Heun's second call on the first step
    want = {k: calls * unet[k] + dec[k] for k in unet}
    kernels = diffusion_kernels()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        for mod in kernels.values():
            mod.launches = 0
        out, t_req = timed_route(torch, system, TASK_A_REPLY)
        launches = expect_launches(kernels, want, f"task A run {i + 1}")
        check(out["status"] == "ok" and out["task"] == "image_generation",
              f"task A: status {out['status']}, task {out.get('task')}")
        img = out["image"]
        check(img.shape == (cfg.image_size, cfg.image_size, 3) and img.dtype == np.uint8,
              f"task A image {img.shape} {img.dtype}")
        runs.append((img, t_req))
        print(f"task A run {i + 1}: request {t_req:.3f} s, image {img.shape} mean "
              f"{img.mean():.2f} std {img.std():.2f} [{card}]", flush=True)
    check(np.array_equal(runs[0][0], runs[1][0]), "task A: two identical requests gave "
          "other images")
    check(int(runs[0][0].max()) != int(runs[0][0].min()), "task A: the image is constant")
    peak = torch.cuda.max_memory_allocated()

    # one CFG UNet call and one VAE decode at the request's shapes, timed alone
    inputs = pipe.prepare("a red car on a street", [[0.1, 0.2, 0.6, 0.8]],
                          ["a red car on a street"])
    from vitron_tpu_torch.models.diffusion import clip_text

    ctx = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_ctx"])
    uc = clip_text.encode(pipe.text_params, cfg.text, inputs["ids_uc"])
    text_emb = torch.zeros((1, cfg.max_objs, cfg.unet.context_dim), device=pipe.device)
    eps = pipe._eps_fn(inputs["params"], ctx, uc, inputs["gb"], inputs["gm"], text_emb, 7.5)
    x = torch.randn((1, cfg.latent_size, cfg.latent_size, 4), device=pipe.device)
    unet_ms = cuda_ms(torch, lambda: eps(x, 501, 1.0), iters=10, warmup=2)
    vae_ms = cuda_ms(torch, lambda: vae.decode(pipe.vae_params, cfg.vae, x), iters=5, warmup=1)
    t_req = runs[1][1]
    print(f"task A: request {t_req:.3f} s ({calls} CFG UNet calls at {unet_ms:.2f} ms = "
          f"{calls * unet_ms / 1e3:.3f} s, VAE decode {vae_ms:.2f} ms, the rest "
          f"{t_req - calls * unet_ms / 1e3 - vae_ms / 1e3:.3f} s), peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    return launches


def phase_task_c(torch, card: str, pipe):
    from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenPipeline
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = dataclasses.replace(pipe.cfg, steps=TASK_C_STEPS)
    short = GligenPipeline(cfg, pipe.unet_params, pipe.vae_params, pipe.text_params,
                           inpaint_unet_params=pipe.inpaint_unet_params,
                           tokenizer=pipe.tokenizer)
    system = VitronSystem(None)
    system.register_gligen(short)
    ucfg9 = dataclasses.replace(cfg.unet, in_channels=9)
    unet = unet_counts(ucfg9, cfg.latent_size, cfg.max_objs, cfg.text.max_length)
    enc, dec = vae_counts(cfg.vae, cfg.latent_size ** 2)
    want = {k: (cfg.steps + 1) * unet[k] + enc[k] + dec[k] for k in unet}
    kernels = diffusion_kernels()
    image = np.random.RandomState(1).randint(0, 256, (480, 640, 3), np.uint8)
    for mod in kernels.values():
        mod.launches = 0
    out, t_req = timed_route(torch, system, TASK_C_REPLY, image=image)
    launches = expect_launches(kernels, want, "task C")
    img = out["image"]
    check(out["status"] == "ok" and out["task"] == "image_editing",
          f"task C: status {out['status']}, task {out.get('task')}")
    check(img.shape == (cfg.image_size, cfg.image_size, 3) and img.dtype == np.uint8
          and int(img.max()) != int(img.min()), f"task C image {img.shape} {img.dtype}")
    print(f"task C ({cfg.steps} PLMS steps, 9-channel UNet, region branch, 480x640 source): "
          f"request {t_req:.3f} s, image mean {img.mean():.2f} std {img.std():.2f} [{card}]",
          flush=True)
    return launches


def phase_sd_unet_bf16(torch, card: str, cfg, dev):
    """bench.py's bench_sd_unet step: x <- x - 0.01 * eps over a CFG batch."""
    from vitron_tpu_torch.models.diffusion import unet2d
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    g = torch.Generator(device=dev).manual_seed(4)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      fill_zero_leaves(unet2d.init_params(g, cfg, dev, grounding=False), g))
    x0 = torch.randn((2, 64, 64, cfg.in_channels), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g, device=dev).to(torch.bfloat16)

    def steps(n):
        x = x0
        for i in range(n):
            eps = unet2d.forward(params, cfg, x, torch.full((2,), float(i), device=dev), ctx)
            x = x - 0.01 * eps.to(x.dtype)
        return x

    out = steps(3)
    check(bool(torch.isfinite(out.float()).all()), "bf16 UNet step gave non-finite values")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(20)
    torch.cuda.synchronize()
    rate = 20 / (time.perf_counter() - t0)
    print(f"sd_unet_cfg_steps_per_s={rate:.3f} (bf16 SD v1.4 UNet, CFG batch 2, 64x64 latents, "
          f"20 steps after 3) [{card}]", flush=True)
    del params
    torch.cuda.empty_cache()
    return rate


def phase_unet_cpu_vs_card(torch, card: str, cfg, dev):
    """One grounded CFG-batch UNet call on the CPU and on `dev`; at full width
    (320 channels, 8 heads, 768-wide context, 30 grounding tokens) but one
    level and 32x32 latents."""
    import os

    from vitron_tpu_torch.models.diffusion import unet2d
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(6)
    params = fill_zero_leaves(unet2d.init_params(g, cfg, cpu), g)
    x = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.full((2,), 501)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)
    objs = torch.randn((2, 30, cfg.context_dim), generator=g)
    t0 = time.perf_counter()
    want = unet2d.forward(params, cfg, x, t, ctx, objs, gate_scale=0.7)
    print(f"unet cpu-vs-card: cpu forward {time.perf_counter() - t0:.1f} s", flush=True)
    p_dev, args = tree_map(lambda a: a.to(dev), params), [a.to(dev) for a in (x, t, ctx, objs)]
    fa = diffusion_kernels()["flash_attention"]
    want_flash = {"flash": unet_counts(cfg, 32, 30, 77)["flash_attention"], "einsum": 0}
    for name, fmin in (("flash", None), ("einsum", str(1 << 30))):
        saved = os.environ.get("VITRON_FLASH_MIN")
        if fmin is not None:
            os.environ["VITRON_FLASH_MIN"] = fmin
        try:
            fa.launches = 0
            got = unet2d.forward(p_dev, cfg, *args, gate_scale=0.7).cpu()
            n_flash = fa.launches
        finally:
            if saved is None:
                os.environ.pop("VITRON_FLASH_MIN", None)
            else:
                os.environ["VITRON_FLASH_MIN"] = saved
        rel = (got - want).abs().max().item() / want.abs().max().item()
        print(f"unet cpu-vs-card ({name} attention on the card, {n_flash} flash launches): "
              f"rel_err={rel:.3e} (limit {UNET_CPU_GPU_TOL[name]}), max |eps| "
              f"{want.abs().max().item():.3f} [{card}]", flush=True)
        check(n_flash == want_flash[name], f"{n_flash} flash launches, expected "
              f"{want_flash[name]}")
        check(rel <= UNET_CPU_GPU_TOL[name], f"diffusion CPU and card disagree ({name}): {rel}")


VIDEO_LATENT = (40, 72)  # 320x576 frames over the SD VAE's factor 8
VIDEO_FRAMES = 24
# max |kernel - plain| / max |plain|: float32 sums in another order; in bf16
# one rounding of the output on each side
VIDEO_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TASK_D_REPLY = ("<module>D</module><instruction>a red car driving along a coastal road at "
                "sunset</instruction>")
# DDIM-v steps of the smoke's task-D request (the reference runs 50): at ~2.5 s
# per float32 CFG UNet call, two requests of 10 steps take ~50 s; a divisor of
# 1000, so the sampler runs exactly this many steps
TASK_D_STEPS = 10
VIDEO_BF16_STEPS = 5


def video_kernels():
    from vitron_tpu_torch.kernels import temporal_attention as ta
    from vitron_tpu_torch.kernels import temporal_conv as tc

    return {"temporal_conv_k3": tc, "frame_attention": ta, **diffusion_kernels()}


def rel_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / want.float().abs().max().item()


def phase_video_kernels(torch, card: str):
    """The task-D path's kernels against their plain versions at every shape
    the path gives them, float32 and bf16, on the same inputs: the temporal
    conv (B6) and frame attention (B7) at the four (N, C, heads) levels of
    the t2v block plan (CFG batch 2 x 24 frames), GEGLU (B3) at those
    levels' rows, group-norm sums (B8) at every [B, R, C] of one UNet call
    and of the VAE decode of the 24 frames (each also run twice for the
    same bits), flash (B2) at the VAE decode's mid attention
    [24, 2880, 1, 512]. Each row: error, device time of the kernel and of
    the library call (CUDA-graph replay) where one PyTorch call computes the
    same function (layout copies made outside the timed region), the plain
    version's (CUDA events where its float32 temporaries would fill a
    graph's pool), and the bound."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn
    from vitron_tpu_torch.kernels import temporal_attention as ta
    from vitron_tpu_torch.kernels import temporal_conv as tc
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    t2v = Text2VideoConfig()
    check(t2v.latent_hw == VIDEO_LATENT and t2v.num_frames == VIDEO_FRAMES,
          f"Text2VideoConfig() latents {t2v.latent_hw} x {t2v.num_frames} frames")
    rows = {"tconv": [], "tattn": [], "geglu_video": [], "gn_video": [], "flash_vae": []}
    b, f = 2, VIDEO_FRAMES
    f32, bf16 = torch.float32, torch.bfloat16

    def peak(dtype):
        return "fp32" if dtype == f32 else "bf16_tensor"

    for n, c, heads in video_sites(t2v.unet, *VIDEO_LATENT):
        m = b * f * n
        x32 = torch.randn((b, f, n, c), generator=g, device=dev)
        w32 = torch.randn((3, c, c), generator=g, device=dev) / (3 * c) ** 0.5
        b32 = 0.1 * torch.randn((c,), generator=g, device=dev)
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[-1]
            x, w, bias = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            got = tc.temporal_conv_k3(x, w, bias)
            want = tc.temporal_conv_k3_plain(x, w, bias)
            err, rel = rel_err(got, want)
            # cuDNN: a (3, 1) filter over the [B, C, F, N] view, padded on F
            xc = x.permute(0, 3, 1, 2).contiguous()
            wc = w.permute(2, 1, 0)[..., None].contiguous()
            lib = F.conv2d(xc, wc, bias, padding=(1, 0)).permute(0, 2, 3, 1)
            _, lib_rel = rel_err(lib, want)
            ms = graph_ms(torch, lambda: tc.temporal_conv_k3(x, w, bias), calls=3)
            plain_ms = cuda_ms(torch, lambda: tc.temporal_conv_k3_plain(x, w, bias), iters=5)
            lib_ms = graph_ms(torch, lambda: F.conv2d(xc, wc, bias, padding=(1, 0)), calls=3)
            flops = 6 * c * c * m
            r = row(err, rel, ms, plain_ms, nbytes(x, w, bias, got), flops, peak(dtype), lib_ms)
            print(f"temporal_conv_k3 [{b},{f},{n},{c}] Co={c} {name}: rel_err={rel:.3e} kernel "
                  f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s) plain {plain_ms:.4f} "
                  f"ms {bound_text(r)} (F.conv2d (3,1) filter, rel {lib_rel:.1e}; kernel and "
                  f"library graph-replayed) [{card}]",
                  flush=True)
            check(rel <= VIDEO_TOL[name], f"temporal_conv_k3 N={n} C={c} {name} rel err {rel}")
            rows["tconv"].append(r)
            del got, want, lib, xc, wc
        del x32, w32

        d = c // heads
        qkv32 = [torch.randn((b, f, n, c), generator=g, device=dev) for _ in range(3)]
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[-1]
            q, k, v = (t.to(dtype) for t in qkv32)
            got = ta.frame_attention(q, k, v, heads, d ** -0.5)
            want = ta.frame_attention_plain(q, k, v, heads, d ** -0.5)
            err, rel = rel_err(got, want)
            qt, kt, vt = (t.reshape(b, f, n, heads, d).permute(0, 2, 3, 1, 4)
                          .reshape(b * n, heads, f, d).contiguous() for t in (q, k, v))
            ms = graph_ms(torch, lambda: ta.frame_attention(q, k, v, heads, d ** -0.5))
            plain_ms = graph_ms(torch, lambda: ta.frame_attention_plain(q, k, v, heads,
                                                                         d ** -0.5), calls=2)
            lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
            r = row(err, rel, ms, plain_ms, nbytes(q, k, v, got), 4 * b * n * heads * f * f * d,
                    peak(dtype), lib_ms)
            print(f"frame_attention [{b},{f},{n},{c}] heads={heads} D={d} {name}: rel_err="
                  f"{rel:.3e} kernel {ms:.4f} ms ({nbytes(q, k, v, got) / (ms * 1e-3) / 1e9:.0f} "
                  f"GB/s) plain {plain_ms:.4f} ms {bound_text(r)} (scaled_dot_product_attention "
                  f"on [B N, H, F, D]; graph-replayed device times) [{card}]", flush=True)
            check(rel <= VIDEO_TOL[name], f"frame_attention N={n} C={c} {name} rel err {rel}")
            rows["tattn"].append(r)
            del got, want, qt, kt, vt
        del qkv32

        fh = 4 * c
        ff32 = [torch.randn(s_, generator=g, device=dev) * sc for s_, sc in (
            ((m, c), 1.0), ((c, 2 * fh), c ** -0.5), ((2 * fh,), 0.1), ((fh, c), fh ** -0.5),
            ((c,), 0.1))]
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[-1]
            args = [t.to(dtype) for t in ff32]
            got = gf.geglu_ff(*args)
            want = gf.geglu_ff_plain(*args)
            err, rel = rel_err(got, want)
            ms = graph_ms(torch, lambda: gf.geglu_ff(*args), calls=2)
            plain_ms = cuda_ms(torch, lambda: gf.geglu_ff_plain(*args), iters=3, warmup=1)
            flops = 6 * m * c * fh
            # two products and a gelu: no single PyTorch call, no library time
            r = row(err, rel, ms, plain_ms, nbytes(*args, got), flops, peak(dtype))
            print(f"geglu_ff M={m} C={c} F={fh} {name}: rel_err={rel:.3e} kernel {ms:.4f} ms "
                  f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, graph-replayed) plain "
                  f"{plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
            check(rel <= GEGLU_TOL[name], f"geglu_ff M={m} C={c} {name} rel err {rel}")
            rows["geglu_video"].append(r)
            del got, want, args
        del ff32

    # B8 at every shape of one CFG UNet call and of the decode of the frames
    unet_gn = video_gn_shapes(t2v.unet, *VIDEO_LATENT, b, f)
    vae_gn = vae_decode_gn_shapes(t2v.vae, *VIDEO_LATENT, f)
    want_n = (video_counts(t2v.unet, *VIDEO_LATENT, t2v.text.max_length)["group_norm_sums"],
              vae_counts(t2v.vae, VIDEO_LATENT[0] * VIDEO_LATENT[1])[1]["group_norm_sums"])
    check((sum(unet_gn.values()), sum(vae_gn.values())) == want_n,
          f"group-norm shapes {sum(unet_gn.values())}, {sum(vae_gn.values())} != counts {want_n}")
    for shape in sorted(unet_gn.keys() | vae_gn.keys()):
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[-1]
            x = x32.to(dtype)
            got, again = gn.group_norm_sums(x), gn.group_norm_sums(x)
            want = gn.group_norm_sums_plain(x)
            err, rel = rel_err(got, want)
            ms = graph_ms(torch, lambda: gn.group_norm_sums(x), calls=5)
            plain_ms = cuda_ms(torch, lambda: gn.group_norm_sums_plain(x), iters=3, warmup=1)
            lib_ms = graph_ms(torch, lambda: torch.var_mean(x, dim=1, correction=0), calls=5)
            r = row(err, rel, ms, plain_ms, nbytes(x, got), 3 * x.numel(), "fp32", lib_ms)
            print(f"group_norm_sums {list(shape)} {name} (x{unet_gn[shape]} a UNet call, "
                  f"x{vae_gn[shape]} a decode; {gn._splits(*shape)} row splits): rel_err={rel:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms, same bits twice="
                  f"{bool(torch.equal(got, again))} {bound_text(r)} (kernel and library "
                  f"graph-replayed) [{card}]", flush=True)
            check(rel <= GN_TOL and bool(torch.equal(got, again)),
                  f"group_norm_sums {list(shape)} {name}: rel err {rel} or not deterministic")
            rows["gn_video"].append(r)
            del x, got, again, want
        del x32

    lh, lw = VIDEO_LATENT
    q, k, v = (torch.randn((VIDEO_FRAMES, lh * lw, 1, 512), generator=g, device=dev).to(bf16)
               for _ in range(3))
    call = dict(causal=False, softmax_shift=0.0)
    got = fa.flash_attention(q, k, v, **call)
    err, rel = rel_err(got, fa.flash_attention_plain(q, k, v, **call))
    ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v, **call), calls=2)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **call), iters=3)
    flops = 4 * VIDEO_FRAMES * (lh * lw) ** 2 * 512
    r = row(err, rel, ms, plain_ms, 4 * nbytes(q), flops, "bf16_tensor", sdpa_ms(torch, q, k, v))
    print(f"flash_attention vae [{VIDEO_FRAMES},{lh * lw},1,512] bf16 non-causal shift 0: "
          f"abs_err={err:.3e} kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"graph-replayed) "
          f"plain {plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
    check(err <= FLASH_TOL, f"flash_attention VAE D=512 abs err {err} > {FLASH_TOL}")
    rows["flash_vae"].append(r)
    del q, k, v, got

    return rows


def build_t2v(torch, cfg, device, seed: int):
    """T2V pipeline (float32, random weights with every zero leaf filled)."""
    from vitron_tpu_torch.models.diffusion import clip_text, unet_sd_video, vae
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoPipeline

    g = torch.Generator(device=device).manual_seed(seed)
    unet = fill_zero_leaves(unet_sd_video.init_params(g, cfg.unet, device), g)
    vae_p = fill_zero_leaves(vae.init_params(g, cfg.vae, device), g)
    text = fill_zero_leaves(clip_text.init_params(g, cfg.text, device), g)
    return Text2VideoPipeline(cfg, unet, vae_p, text,
                              tokenizer=StubClipTokenizer(cfg.text.vocab_size))


def phase_task_d(torch, card: str, pipe):
    """A routed task-D reply, twice: `cfg.steps` DDIM-v steps of one CFG UNet
    call each, then the VAE decode of the frames. Identical frames both
    times, finite latent and decoded frames before the uint8 cast,
    non-constant frames, and launches of every kernel equal to the block
    plan's count x steps plus the VAE decode's. Then one CFG UNet call and
    one VAE decode at the request's shapes, timed alone."""
    from vitron_tpu_torch.models.diffusion import clip_text, vae
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = pipe.cfg
    system = VitronSystem(None)
    system.register_text2video(pipe)
    lh, lw = cfg.latent_hw
    per_call = video_counts(cfg.unet, lh, lw, cfg.text.max_length)
    _, dec = vae_counts(cfg.vae, lh * lw)
    want = {k: cfg.steps * per_call[k] + dec.get(k, 0) for k in per_call}
    kernels = video_kernels()
    decoded = []
    decode = vae.decode

    def recorded_decode(params, vcfg, z):
        out = decode(params, vcfg, z)
        decoded.append((bool(torch.isfinite(z).all()), bool(torch.isfinite(out).all()),
                        z.float().std().item(), out.float().abs().max().item()))
        return out

    torch.cuda.reset_peak_memory_stats()
    runs = []
    vae.decode = recorded_decode
    try:
        for i in range(2):
            for mod in kernels.values():
                mod.launches = 0
            out, t_req = timed_route(torch, system, TASK_D_REPLY)
            launches = expect_launches(kernels, want, f"task D run {i + 1}")
            check(out["status"] == "ok" and out["task"] == "video_generation",
                  f"task D: status {out['status']}, {out.get('error')}")
            video = out["video"]
            z_ok, frames_ok, z_std, fmax = decoded[-1]
            check(video.shape == (cfg.num_frames, cfg.height, cfg.width, 3)
                  and video.dtype == np.uint8, f"task D video {video.shape} {video.dtype}")
            check(z_ok and frames_ok, "task D: non-finite latent or decoded frames")
            check(int(video.max()) != int(video.min()), "task D: the frames are constant")
            runs.append(video)
            print(f"task D run {i + 1}: request {t_req:.3f} s ({cfg.steps} DDIM-v steps), video "
                  f"{video.shape} mean {video.mean():.2f} std {video.std():.2f}; final latent std "
                  f"{z_std:.3f}, decoded max |x| {fmax:.3f} before the clamp, finite [{card}]",
                  flush=True)
    finally:
        vae.decode = decode
    check(np.array_equal(runs[0], runs[1]), "task D: two identical requests gave other frames")
    peak_mem = torch.cuda.max_memory_allocated()

    ids = pipe.tokenize(["a red car", ""])
    v_fn = pipe.v_fn(clip_text.encode(pipe.text_params, cfg.text, ids))
    g = torch.Generator(device=pipe.device).manual_seed(5)
    x = torch.randn((1, cfg.num_frames, lh, lw, cfg.unet.in_dim), generator=g,
                    device=pipe.device)
    unet_ms = cuda_ms(torch, lambda: v_fn(x, 501), iters=3, warmup=1)
    vae_ms = cuda_ms(torch, lambda: vae.decode(pipe.vae_params, cfg.vae, x[0]), iters=2,
                     warmup=1)
    video_breakdown(torch, card, lambda: v_fn(x, 501), unet_ms)
    print(f"task D: request {t_req:.3f} s ({cfg.steps} CFG UNet calls at {unet_ms:.2f} ms = "
          f"{cfg.steps * unet_ms / 1e3:.3f} s, VAE decode of {cfg.num_frames} frames "
          f"{vae_ms:.2f} ms, the rest {t_req - cfg.steps * unet_ms / 1e3 - vae_ms / 1e3:.3f} s), "
          f"peak memory {peak_mem / 2**30:.2f} GiB (float32 UNetSD_T2V, 320x576, "
          f"{cfg.num_frames} frames) [{card}]", flush=True)
    return launches


# device kernels of a video UNet call by what launched them: the port's
# GEMM template (mode 1 = B6's temporal conv, 0 and 2 = B3's two products,
# plus its split-K reduction), B7, B8, cuDNN's convolutions, cuBLAS's
# products (projections, attention einsums), and the rest (PyTorch's
# elementwise and reduction kernels); the first pattern that matches counts
VIDEO_KERNEL_GROUPS = (
    ("B6 temporal_conv_k3", r"gemm_(f32|bf16_tc)_kernel<1\b"),
    ("B3 geglu_ff", r"gemm_(f32|bf16_tc)_kernel<[02]\b|split_k_reduce"),
    ("B7 frame_attention", r"frame_attention_kernel"),
    ("B8 group_norm_sums", r"gn_sums_kernel|gn_split_reduce"),
    ("convolutions (cuDNN)", r"conv|implicit|cudnn|fprop|winograd"),
    ("products (cuBLAS)", r"gemm|cutlass"))


def video_breakdown(torch, card: str, call, unprofiled_ms: float):
    """Where one CFG video UNet call's device time goes: a torch.profiler
    trace of the call, its kernels' device time summed by group and by name,
    and the device's busy share of the unprofiled call."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
              if e.device_type == cuda}
    busy = sum(dev_ms.values())
    groups = {name: 0.0 for name, _ in VIDEO_KERNEL_GROUPS}
    groups["the rest"] = 0.0
    for key, ms in dev_ms.items():
        name = next((n for n, pat in VIDEO_KERNEL_GROUPS if re.search(pat, key)), "the rest")
        groups[name] += ms
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    print(f"task D breakdown: one float32 CFG UNet call {unprofiled_ms:.1f} ms unprofiled, "
          f"device busy {busy:.1f} ms = {busy / unprofiled_ms:.3f} of it (idle share "
          f"{1 - busy / unprofiled_ms:.3f}); by group (ms): "
          + "; ".join(f"{k} {v:.1f}" for k, v in groups.items()) + f" [{card}]", flush=True)
    print("task D device time by kernel (ms): " + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top),
          flush=True)


def phase_video_unet_bf16(torch, card: str, dev):
    """bench.py's bench_video_unet step: x <- x - 0.01 * v over a CFG batch of
    2 x 24 frames of 40x72 latents, bf16 params, [2, 77, 1024] context; the
    MFU counts the block plan's FLOP against 989 TFLOP/s."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video as usv
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = usv.UNetSDVideoConfig.t2v()
    g = torch.Generator(device=dev).manual_seed(11)
    params = tree_map(lambda t: t.to(torch.bfloat16),
                      fill_zero_leaves(usv.init_params(g, cfg, dev), g))
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in tree_leaves(params))
    lh, lw = VIDEO_LATENT
    x0 = torch.randn((2, VIDEO_FRAMES, lh, lw, 4), generator=g, device=dev).to(torch.bfloat16)
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g, device=dev).to(torch.bfloat16)

    def steps(n):
        x = x0
        for i in range(n):
            v = usv.forward(params, cfg, x, torch.full((2,), float(i), device=dev), y=ctx)
            x = x - 0.01 * v.to(x.dtype)
        return x

    out = steps(2)
    check(bool(torch.isfinite(out.float()).all()), "bf16 video UNet step gave non-finite values")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(VIDEO_BF16_STEPS)
    torch.cuda.synchronize()
    rate = VIDEO_BF16_STEPS / (time.perf_counter() - t0)
    flops = video_unet_flops(cfg, lh, lw, VIDEO_FRAMES, 2, 77)
    mfu = flops * rate / PEAK_FLOPS["bf16_tensor"]
    print(f"video_unet_cfg_steps_per_s={rate:.4f} video_unet_mfu={mfu:.4f} (bf16 UNetSD_T2V, "
          f"{n_params / 1e9:.3f}B params counted in the built tree, CFG batch 2 x "
          f"{VIDEO_FRAMES} frames, 40x72 latents, {VIDEO_BF16_STEPS} steps after 2; "
          f"{flops / 1e12:.2f} TFLOP a step from the block plan, against 989 TFLOP/s) [{card}]",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return rate


def phase_video_cpu_vs_card(torch, card: str):
    """One float32 CFG-batch call of the t2v UNet at its real widths but
    reduced depth (two levels, 512 and 1024 channels), 8 frames and 16x16
    latents, on the CPU and on the card: B6 at C 512/1024, B7 at 8 and 16
    heads, B3 at C 512/1024 on the card."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video as usv
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = usv.UNetSDVideoConfig.t2v(dim_mult=(1, 2))
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(12)
    params = fill_zero_leaves(usv.init_params(g, cfg, cpu), g)
    x = torch.randn((2, 8, 16, 16, 4), generator=g)
    t = torch.tensor([501.0, 501.0])
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)
    t0 = time.perf_counter()
    want = usv.forward(params, cfg, x, t, y=ctx)
    print(f"video cpu-vs-card: cpu forward {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    kernels = video_kernels()
    for mod in kernels.values():
        mod.launches = 0
    got = usv.forward(tree_map(lambda a: a.to(dev), params), cfg, x.to(dev), t.to(dev),
                      y=ctx.to(dev)).cpu()
    expect_launches(kernels, video_counts(cfg, 16, 16, 77), "video cpu-vs-card")
    rel = (got - want).abs().max().item() / want.abs().max().item()
    print(f"video cpu-vs-card: float32 t2v UNet (levels 512/1024, 8 frames, 16x16 latents) "
          f"rel_err={rel:.3e} (limit {CPU_GPU_TOL}), max |v| {want.abs().max().item():.3f} "
          f"[{card}]", flush=True)
    check(rel <= CPU_GPU_TOL, f"video UNet CPU and card disagree: {rel}")


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


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

    image = np.random.RandomState(0).randint(0, 256, (336, 448, 3), np.uint8)
    one = SamplingConfig(greedy=True, max_new_tokens=1, eos_ids=())
    logits = {}
    for name, device, p in (("cuda", dev, params), ("cpu", torch.device("cpu"), tree_map(lambda a: a.cpu(), params))):
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
    torch.backends.cudnn.deterministic = True
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from vitron_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.library_path()
    _build.lib()
    how = (f"nvcc {_build.build_seconds:.1f} s, per source "
           + ", ".join(f"{k} {v:.1f} s" for k, v in _build.compile_seconds.items())
           if _build.build_seconds is not None else "already built")
    print(f"build: {path} ({how}; {time.perf_counter() - t0:.1f} s in all)", flush=True)

    with torch.no_grad():
        rows = phase_kernels(torch, card)
        rows.update(phase_diffusion_kernels(torch, card))
        rows.update(phase_seem_kernels(torch, card))
        rows.update(phase_video_kernels(torch, card))
        chat = phase_slice(torch, card)
        phase_cpu_vs_card(torch, card)
        from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig
        from vitron_tpu_torch.models.diffusion.unet2d import UNetConfig
        from vitron_tpu_torch.models.seem.model import SeemConfig

        dev = torch.device("cuda")
        seem_cfg = SeemConfig()
        t0 = time.perf_counter()
        seem_params = build_seem_params(torch, seem_cfg, dev, seed=0)
        system = seem_system(torch, seem_cfg, seem_params)
        torch.cuda.synchronize()
        print(f"seem: FocalNet-L + FPN pixel decoder (bf16) + SEEM decoder + language "
              f"encoder (float32) random weights built on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        task_b = phase_task_b(torch, card, system, seem_cfg)
        seem_breakdown(torch, card, system,
                       np.random.RandomState(3).randint(0, 256, (480, 640, 3), np.uint8))
        task_e = phase_task_e(torch, card, system, seem_cfg)
        del system
        t0 = time.perf_counter()
        pipe = build_gligen(torch, GligenConfig(), dev, seed=0)
        torch.cuda.synchronize()
        print(f"gligen: SD v1.4 GLIGEN UNet (4 and 9 channels), SD VAE, CLIP-L text, float32 "
              f"random weights built on the card in {time.perf_counter() - t0:.1f} s", flush=True)
        task_a = phase_task_a(torch, card, pipe)
        task_c = phase_task_c(torch, card, pipe)
        task_c_seem = phase_task_c_seem(torch, card, pipe, seem_params, seem_cfg)
        del pipe, seem_params
        torch.cuda.empty_cache()
        phase_sd_unet_bf16(torch, card, UNetConfig.sd_v1(), dev)
        phase_unet_cpu_vs_card(torch, card, UNetConfig.sd_v1(
            channel_mult=(1,), num_res_blocks=1, attention_resolutions=(1,)), dev)
        phase_seem_cpu_vs_card(torch, card)
        from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

        t0 = time.perf_counter()
        pipe = build_t2v(torch, Text2VideoConfig(steps=TASK_D_STEPS), dev, seed=0)
        torch.cuda.synchronize()
        n_unet = sum(t.numel() for t in tree_leaves(pipe.unet_params))
        print(f"t2v: UNetSD_T2V ({n_unet / 1e9:.3f}B params), SD VAE, CLIP text (1024 wide), "
              f"float32 random weights built on the card in {time.perf_counter() - t0:.1f} s",
              flush=True)
        task_d = phase_task_d(torch, card, pipe)
        del pipe
        torch.cuda.empty_cache()
        phase_video_unet_bf16(torch, card, dev)
        phase_video_cpu_vs_card(torch, card)

    def entry(name, source, replaces, key, launches, paths):
        r = rows[key]
        bytes_ms, ops_ms = sum(x["bytes_ms"] for x in r), sum(x["ops_ms"] for x in r)
        lib = [x["library_ms"] for x in r]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": paths,
                "max_abs_err": max(x["err"] for x in r),
                "max_rel_err": max(x["rel"] for x in r), "ms": sum(x["ms"] for x in r),
                "plain_ms": sum(x["plain_ms"] for x in r),
                "bound_ms": sum(max(x["bytes_ms"], x["ops_ms"]) for x in r),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None if None in lib else sum(lib),
                "ms_is": f"sum over the {len(r)} main-path shapes above"}

    def paths(name):
        return {"chat": chat.get(name, 0), "task_a": task_a.get(name, 0),
                "task_c": task_c.get(name, 0), "task_b": task_b.get(name, 0),
                "task_e": task_e.get(name, 0), "task_c_seem": task_c_seem.get(name, 0),
                "task_d": task_d.get(name, 0)}

    rows["flash"] += rows.pop("flash_gligen") + rows.pop("flash_vae")
    rows["geglu"] += rows.pop("geglu_video")
    rows["gn"] += rows.pop("gn_video")
    print(json.dumps({"kernels": [
        entry("int4_matmul", "vitron_tpu_torch/csrc/int4_matmul.cu",
              "vitron_tpu/kernels/int4_matmul.py:108", "int4", chat["int4_matmul"],
              paths("int4_matmul")),
        entry("flash_attention", "vitron_tpu_torch/csrc/flash_attention_fwd.cu",
              "vitron_tpu/kernels/flash_attention.py:242", "flash",
              task_a["flash_attention"], paths("flash_attention")),
        entry("geglu_ff", "vitron_tpu_torch/csrc/geglu_ff.cu",
              "vitron_tpu/kernels/geglu_ff.py:90", "geglu", task_a["geglu_ff"],
              paths("geglu_ff")),
        entry("group_norm_sums", "vitron_tpu_torch/csrc/group_norm.cu",
              "vitron_tpu/kernels/group_norm.py:75", "gn", task_a["group_norm_sums"],
              paths("group_norm_sums")),
        entry("depthwise_conv2d", "vitron_tpu_torch/csrc/depthwise_conv.cu",
              "vitron_tpu/kernels/depthwise_conv.py:66", "dw", task_b["depthwise_conv2d"],
              paths("depthwise_conv2d")),
        entry("temporal_conv_k3", "vitron_tpu_torch/csrc/temporal_conv.cu",
              "vitron_tpu/kernels/temporal_conv.py:81", "tconv", task_d["temporal_conv_k3"],
              paths("temporal_conv_k3")),
        entry("frame_attention", "vitron_tpu_torch/csrc/temporal_attention.cu",
              "vitron_tpu/kernels/temporal_attention.py:97", "tattn", task_d["frame_attention"],
              paths("frame_attention")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
