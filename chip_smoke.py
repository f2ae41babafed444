#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vitron_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no `ok` line):
1. device: the `nvidia-smi` name and power limit; exit 1 without CUDA;
   TF32 off for matmuls and cuDNN, deterministic cuDNN algorithms.
2. build: the hand CUDA kernels from `vitron_tpu_torch/csrc/` (one nvcc per
   source, all started together, sm_90a).
3. kernel vs plain at the chat path's shapes: int4_matmul (bf16 x, M in
   {1, 384}, the four Vicuna-7B (K, N) pairs; each output row within
   INT4_ROW_REL of its largest, the same bits twice, CUDA-event times with
   the weights flushed from L2 by a read, GB/s at M 1 and TFLOP/s at M 384
   beside the bound, and torch.matmul on the pre-dequantized bf16 weight
   as a reference, not a library port) and flash_attention (bf16, D = 128:
   masked prefill, cached chunk, GQA); error and CUDA-event times.
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
5c. B9 (conv3x3_same) against its plain version, float32 and bf16, at the
   16 distinct eligible stride-1 3x3 convs of the i2vgen UNet at task G's
   64x64 latents, batch 2 x 16 (from the block plan), beside cuDNN's bf16
   F.conv2d on the rounded inputs; then its VJP (dx through the kernel)
   against the plain VJP at a 32x32 level shape. No main path calls it.
5d. kernel vs plain at the task-G path's shapes, float32 and bf16: B6, B7
   and B3 at the i2vgen plan's four levels (2 x 16 frames of 64x64), B8 at
   every [B, R, C] of one UNet call, the 512^2 VAE encode and the 16-frame
   decode, and B2 at D 512 (encode [1, 4096, 1, 512], decode
   [16, 4096, 1, 512]) and D 64 (the 32x32 level's self-attention,
   [32, 1024, 16, 64]).
   Every kernel row of phases 3-5d prints its bound (bytes once at
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
15b. task G at full width: `Image2VideoConfig()` (UNetSD_I2VGen, SD VAE,
   CLIP text 1024 wide, float32, 16 frames at 512x512, fps 16, guidance 9)
   with random weights (zero leaves filled) and a seeded stub image
   embedder, built after task D's pipeline is freed; a fixed protocol reply
   routed to the port's `handle_g` with a 480x640 image (resized on the
   host, ROADMAP C7), TASK_G_STEPS DDIM-v steps, twice: identical, finite,
   non-constant frames; launches of all five kernels against the block plan
   x steps plus the VAE encode's and decode's, none of B9; request time, ms
   per CFG UNet call, VAE encode and decode ms, peak memory.
16. the bf16 CFG video UNet step at bench.py's `bench_video_unet` shape
   ([2, 24, 40, 72, 4] latents, [2, 77, 1024] context):
   `video_unet_cfg_steps_per_s` and `video_unet_mfu` (the block plan's FLOP
   against 989 TFLOP/s).
17. the video path on the CPU and the card: one float32 CFG-batch t2v UNet
   call at the real widths but two levels (512/1024), 8 frames, 16x16
   latents.
17b. the i2v path on the CPU and the card: one float32 CFG-batch i2vgen UNet
   call at the real widths but two levels (512/1024), 8 frames, 16x16
   latents, with text, local-image and global conditioning.
18. the training kernels against their plain versions, bf16 and float32:
   the flash forward with its LSE (B2), dK/dV (B5a) and dQ (B5b) at the
   trainer's [2, 2048, 32, 128] (causal, right-padded kv_mask), a GQA row
   (32 query heads on 8, q_offset 512) and a non-causal D 64 row; errors of
   out, lse, dq, dk, dv, each output row at its own scale (B2's query rows
   within FLASH_ROW_REL, dq's query rows and dk's and dv's key rows within
   FLASH_BWD_ROW_REL), the same bits twice, CUDA-event times beside the
   bound, B5a + B5b's rate over the seven products they run and the SDPA
   backward; then B1 at the trainer's M = 4096 rows and the four (K, N)
   pairs (TFLOP/s beside the bound, per-row limit, the same bits twice).
19. the LoRA trainer at full width: `Trainer.fit` on
   `VitronConfig.serving(llm=vicuna_7b(attn_impl="flash", max_seq_len=2048))`
   with random packed-int4 projections and lm_head and a bf16 ViT-L/14,
   LoRA r 128 on all seven targets + projector + region extractor, AdamW
   2e-4 with warmup-cosine, TRAIN_BATCH rows of 2048, TRAIN_STEPS steps,
   twice from the same state: finite, equal losses; LoRA b and projector
   still at step 1 (learning rate 0) and moved at step 2; launches = the
   config's a step; step seconds, trained tokens/s, peak memory; a profiled
   step by kernel group, and the device time of B1's backward dequantize.
20. training on the CPU and the card: one LoRA step's loss and gradients
   on a 2-layer full-width float32 model with int4 projections, pad_len 512.
Then one line lists each bf16 B2 row (the 15 of phases 3, 4, 5b, 5d and 18
that every main path's type gives it) with its kernel ms beside
F.scaled_dot_product_attention's. The line before the last is a JSON object
with one entry per kernel (with its launches on each main path); the last
line is {"ok": true, "device": {...}}.
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
# B1's bf16 rows are also held at each output row's scale: max |kernel -
# plain| over a row over that row's largest |plain|. Both sides round the
# same float32 sums (summed in other orders) to bf16, so an output flips by
# at most one bf16 ulp, 2^-7 of its own size.
INT4_ROW_REL = 2 ** -7
FLASH_TOL = 2e-2  # max |kernel - plain| on unit-normal bf16 inputs
# B2 is also held at each query row's own scale: max |kernel - plain| over a
# row's D outputs over that row's largest |plain| (a row whose plain outputs
# are all 0 must be 0). The kernel rounds p against its running max and the
# plain version against the row max, and both round the output to bf16: one
# output flip is at most one bf16 ulp, 2^-7 of the row's largest. Dropping
# one 64-key tile of 4,096 keys, or the 30-key ragged tail at 4,126, moves a
# row by ~0.08 of its largest (unit-normal inputs).
FLASH_ROW_REL = 2 ** -6
# B5a and B5b are held at each output row's scale too (flash_row_rel):
# query rows of dq, key rows of dk and dv. The H100 read 7.46e-3 to
# 9.22e-3 in bf16 at the training rows (float32 sums in other orders flip
# roundings of p, ds and the outputs: one bf16 ulp is 2^-7 of a row's
# largest; the GQA row's dv adds four heads' roundings), so the bf16 limit
# is 2^-6, as B2's; float32 read 0 (the FMA kernels add each
# output's terms in the order of the plain version's products). Dropping one
# 64-key tile of a dq row or one 64-query tile of a dk/dv row moves the row
# by ~(64 / rows summed)^(1/2) of its largest: 0.18 at 2,048. A row where
# the plain output is cancellation noise -- a causal row that sees one key
# has ds = p (dP - delta) with delta = dP, so JAX's dq is 0 up to the order
# of float32 sums -- is held at FLASH_BWD_ROW_FLOOR of the tensor's largest.
FLASH_BWD_ROW_REL = {"bfloat16": 2 ** -6, "float32": 1e-4}
FLASH_BWD_ROW_FLOOR = 2 ** -10
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
    """Median CUDA-event time of fn() in ms; `flush` (a buffer larger than
    the 50 MB L2) is read before each run, so the weights come from device
    memory, as they do in decode, and the L2 holds clean lines, as it does
    there (the previous projection's weights). Writing the buffer instead
    would leave ~50 MB of dirty lines whose write-back the timed call pays:
    ~15 us at 3.35 TB/s, a cost no decode step has."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.max()
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


def flash_row_rel(got, want, floor: float = 0.0) -> float:
    """max over rows of max |got - want| over the row's D outputs divided by
    the row's largest |want|, or by `floor` times the tensor's largest
    |want| where that is larger (0/0 counts as 0), for [..., D] outputs:
    B2's query rows, and with floor FLASH_BWD_ROW_FLOOR the query rows of
    B5b's dq and the key rows of B5a's dk and dv."""
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    scale = scale.clamp_min(max(floor * scale.max().item(), 1e-30))
    return (diff / scale).max().item()


def int4_row(torch, card: str, g, m: int, k: int, n: int, flush=None, iters: int = 20) -> dict:
    """B1 against its plain version on x [m, k] bf16 and a random packed
    [k/2, n] weight with scales: max |kernel - plain| over max |plain| and at
    each output row's scale (INT4_ROW_REL), the same bits twice, CUDA-event
    times of the kernel and the plain version (`flush` read before each run,
    so the weights come from device memory as they do in decode), the
    bound and the rate (GB/s of packed bytes for the GEMV, TFLOP/s above).
    Beside them, torch.matmul of x with the weight dequantized to bf16
    beforehand: a reference only, on other inputs (four times the weight
    bytes), not a library call of the same function -- no PyTorch call takes
    this int4 packing."""
    from vitron_tpu_torch.kernels import int4_matmul as i4

    dev = torch.device("cuda")
    q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8, device=dev)
    s = torch.rand((1, n), generator=g, device=dev) * 0.02 + 0.01
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    got, again = i4.int4_matmul(x, q4, s), i4.int4_matmul(x, q4, s)
    want = i4.int4_matmul_plain(x, q4, s)
    err, rel = rel_err(got, want)
    row_rel = flash_row_rel(got, want)
    same = bool(torch.equal(got, again))
    del again, want
    ms = cuda_ms(torch, lambda: i4.int4_matmul(x, q4, s), iters=iters, flush=flush)
    plain_ms = cuda_ms(torch, lambda: i4.int4_matmul_plain(x, q4, s), iters=min(iters, 5),
                       flush=flush)
    w = (i4.unpack_int4(q4).float() * s).to(torch.bfloat16)
    ref_ms = cuda_ms(torch, lambda: torch.matmul(x, w), iters=iters, flush=flush)
    del w
    flops = 2 * m * k * n
    r = dict(row(err, rel, ms, plain_ms, nbytes(x, q4, s, got), flops, "bf16_tensor"),
             ref_ms=ref_ms, row_rel=row_rel)
    rate = (f"{q4.numel() / (ms * 1e-3) / 1e9:.0f} GB/s packed" if m <= i4.GEMV_MAX_M
            else f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    print(f"int4_matmul M={m} K={k} N={n} bf16: rel_err={rel:.3e} abs_err={err:.3e} "
          f"row_rel_err={row_rel:.3e} (limit {INT4_ROW_REL:.3e}), same bits twice="
          f"{same}; kernel {ms:.4f} ms ({rate}) plain {plain_ms:.4f} ms {bound_text(r)}; "
          f"reference, not a port: torch.matmul on the pre-dequantized bf16 weight "
          f"{ref_ms:.4f} ms [{card}]", flush=True)
    check(rel <= INT4_TOL and row_rel <= INT4_ROW_REL and same,
          f"int4_matmul M={m} K={k} N={n}: rel err {rel} (limit {INT4_TOL}), row rel err "
          f"{row_rel} (limit {INT4_ROW_REL}), same bits twice {same}")
    return r


def check_flash(what: str, err: float, row_rel: float) -> None:
    check(err <= FLASH_TOL and row_rel <= FLASH_ROW_REL,
          f"flash_attention {what}: abs err {err} (limit {FLASH_TOL}), row rel err {row_rel} "
          f"(limit {FLASH_ROW_REL})")


# B2's rows in the smoke: the chat path's (name, S, T, N, KH, q_offset,
# valid slots; B 1, D 128, causal), the GLIGEN path's ([B, S, N, D], keys S,
# non-causal, shift 0), the video paths' (`video_flash_sites`) and the
# trainer's (TRAIN_FLASH_CASES); `b2_shapes` lists them all
CHAT_FLASH_CASES = (
    ("prefill", 384, 512, 32, 32, 0, 305),
    ("cached-chunk", 64, 512, 32, 32, 128, 192),
    ("gqa", 384, 512, 32, 8, 0, 305),
)
GLIGEN_FLASH_SHAPES = ((2, 4096, 8, 40), (2, 4126, 8, 40), (2, 1024, 8, 80), (2, 1054, 8, 80),
                       (1, 4096, 1, 512))


def phase_kernels(torch, card: str):
    from vitron_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    rows = {"int4": [], "flash": []}
    for m in (1, 384):
        for k, n in INT4_SHAPES:
            rows["int4"].append(int4_row(torch, card, g, m, k, n, flush=flush))
        print_sums(f"B1 at M {m}", rows["int4"][-len(INT4_SHAPES):], card)

    b, d = 1, 128
    for name, s_len, t_len, nh, kh, off, n_valid in CHAT_FLASH_CASES:
        q = torch.randn((b, s_len, nh, d), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, t_len, kh, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, t_len, kh, d), generator=g, device=dev).to(torch.bfloat16)
        mask = torch.zeros((b, t_len), dtype=torch.bool, device=dev)
        mask[:, :n_valid] = True
        got = fa.flash_attention(q, k, v, kv_mask=mask, q_offset=off).float()
        want = fa.flash_attention_plain(q, k, v, kv_mask=mask, q_offset=off).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        row_rel = flash_row_rel(got, want)
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, kv_mask=mask, q_offset=off))
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, kv_mask=mask,
                                                                   q_offset=off))
        visible = fa._visible(b, s_len, t_len, dev, mask, off, True)[:, 0, 0]  # [B, S, T]
        lib_ms = sdpa_ms(torch, q, k, v, visible[:, None])
        flops = 4 * d * nh * int(visible.sum())
        r = dict(row(err, rel, ms, plain_ms, nbytes(q, k, v, mask, got.to(torch.bfloat16)),
                     flops, "bf16_tensor", lib_ms), b2=f"chat {name}")
        print(f"flash_attention {name} S={s_len} T={t_len} N={nh} K={kh} D={d} "
              f"q_offset={off}: abs_err={err:.3e} rel_err={rel:.3e} row_rel_err={row_rel:.3e} "
              f"kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s) plain "
              f"{plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check_flash(name, err, row_rel)
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
    for b, s_len, heads, d in GLIGEN_FLASH_SHAPES:
        q, k, v = (torch.randn((b, s_len, heads, d), generator=g, device=dev).to(bf16)
                   for _ in range(3))
        call = dict(causal=False, softmax_shift=0.0)
        got = fa.flash_attention(q, k, v, **call).float()
        want = fa.flash_attention_plain(q, k, v, **call).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        row_rel = flash_row_rel(got, want)
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **call), iters=10)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **call), iters=10)
        flops = 4 * b * heads * s_len * s_len * d
        tflops = flops / (ms * 1e-3) / 1e12
        r = dict(row(err, rel, ms, plain_ms, 4 * nbytes(q), flops, "bf16_tensor",
                     sdpa_ms(torch, q, k, v)), b2=f"gligen [{b},{s_len},{heads},{d}]")
        print(f"flash_attention gligen [{b},{s_len},{heads},{d}] bf16 non-causal shift 0: "
              f"abs_err={err:.3e} rel_err={rel:.3e} row_rel_err={row_rel:.3e} kernel "
              f"{ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {plain_ms:.4f} ms {bound_text(r)} "
              f"[{card}]", flush=True)
        check_flash(f"D={d} S={s_len}", err, row_rel)
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
    image = np.random.RandomState(3).randint(0, 256, (480, 640, 3), np.uint8)
    sketch = stroke_mask(480, 640)
    total = collections.Counter()
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
                reset_launches()
                out, t_req = timed_route(torch, system, reply, image=image, sketch_mask=sk)
                total.update(expect_launches(per, f"task B {name} run {i + 1}"))
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
    return dict(total)


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
    video = np.random.RandomState(4).randint(0, 256, (frames, 480, 640, 3), np.uint8)
    runs = []
    for i in range(2):
        reset_launches()
        out, t_req = timed_route(torch, system, TASK_E_REPLY, video=video,
                                 sketch_mask=stroke_mask(480, 640))
        launches = expect_launches(want, f"task E run {i + 1}")
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
    image = np.random.RandomState(5).randint(0, 256, (480, 640, 3), np.uint8)
    reset_launches()
    out, t_req = timed_route(torch, system, TASK_C_SEEM_REPLY, image=image)
    launches = expect_launches(want, "task C (SEEM branch)")
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
    from vitron_tpu_torch.models.diffusion.unet_sd_video import block_plan_hw

    for e, h, w in block_plan_hw(ucfg, lh, lw):
        yield e, h * w


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


def vae_encode_gn_shapes(vcfg, h: int, w: int, batch: int) -> collections.Counter:
    """[B, R, C] of every group-norm-sums launch of one VAE encode of
    [batch, h, w, 3] images, with its count: each level's ResNets (norm1 at
    their input width, norm2 at their output width, a quarter of the rows
    after each downsampling), the mid ResNets' four and the mid attention's
    one at the top width, and the output norm."""
    bc = vcfg.base_channels
    ch, rows = bc, h * w
    shapes = collections.Counter()
    for li, mult in enumerate(vcfg.channel_mult):
        for _ in range(vcfg.num_res_blocks):
            shapes[(batch, rows, ch)] += 1
            ch = mult * bc
            shapes[(batch, rows, ch)] += 1
        if li != len(vcfg.channel_mult) - 1:
            rows //= 4
    shapes[(batch, rows, ch)] += 6
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


# every kernel's launch counter: its name in the kernels line, its module
# under vitron_tpu_torch.kernels and the module's counter
LAUNCH_COUNTERS = (
    ("int4_matmul", "int4_matmul", "launches"),
    ("flash_attention", "flash_attention", "launches"),
    ("flash_attention_bwd_kv", "flash_attention", "bwd_kv_launches"),
    ("flash_attention_bwd_q", "flash_attention", "bwd_q_launches"),
    ("geglu_ff", "geglu_ff", "launches"),
    ("group_norm_sums", "group_norm", "launches"),
    ("depthwise_conv2d", "depthwise_conv", "launches"),
    ("temporal_conv_k3", "temporal_conv", "launches"),
    ("frame_attention", "temporal_attention", "launches"),
    ("conv3x3_same", "conv2d", "launches"),
)


def _counters():
    import importlib

    return [(name, importlib.import_module(f"vitron_tpu_torch.kernels.{mod}"), attr)
            for name, mod, attr in LAUNCH_COUNTERS]


def reset_launches() -> None:
    """Every kernel's launch count to 0: just before a run that is read."""
    for _, mod, attr in _counters():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    """Every kernel's launch count since `reset_launches`."""
    return {name: getattr(mod, attr) for name, mod, attr in _counters()}


def expect_launches(want: dict, what: str) -> dict:
    """Every kernel's launch count since `reset_launches`; those named in
    `want` must equal it, and B9, which no path calls, must be 0."""
    want = {"conv3x3_same": 0, **want}
    got = read_launches()
    print(f"{what}: launches {got} (expected {want})", flush=True)
    check(all(got[k] == v for k, v in want.items()), f"{what}: kernel launches {got} != {want}")
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
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(2):
        reset_launches()
        out, t_req = timed_route(torch, system, TASK_A_REPLY)
        launches = expect_launches(want, f"task A run {i + 1}")
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
    image = np.random.RandomState(1).randint(0, 256, (480, 640, 3), np.uint8)
    reset_launches()
    out, t_req = timed_route(torch, system, TASK_C_REPLY, image=image)
    launches = expect_launches(want, "task C")
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

    from vitron_tpu_torch.kernels import flash_attention as fa
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
I2V_LATENT = 64   # 512^2 frames over the SD VAE's factor 8
I2V_FRAMES = 16
TASK_G_REPLY = ("<module>G</module><instruction>the waves roll in and the boat drifts slowly"
                "</instruction>")
# DDIM-v steps of the smoke's task-G request (the reference runs 50), a
# divisor of 1000 (ROADMAP C6); 5 if the whole smoke passes ~450 s
TASK_G_STEPS = 10


def i2v_context(ucfg, text_len: int) -> int:
    """Context tokens of the i2vgen UNet `ucfg` after `text_len` text tokens:
    those, the 64 local-image tokens (a 32x32 pool, two stride-2 convs) and
    the global ones."""
    return text_len + 64 + ucfg.num_tokens


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
    [24, 2880, 1, 512] (bf16, as `layers._mha` calls it)."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

    t2v = Text2VideoConfig()
    check(t2v.latent_hw == VIDEO_LATENT and t2v.num_frames == VIDEO_FRAMES,
          f"Text2VideoConfig() latents {t2v.latent_hw} x {t2v.num_frames} frames")
    return video_kernel_rows(torch, card, t2v.unet, t2v.vae, *VIDEO_LATENT, VIDEO_FRAMES,
                             t2v.text.max_length, seed=9)


def video_flash_sites(ucfg, lh: int, lw: int, frames: int, n_ctx: int, encode: bool):
    """(what, B, S, T, heads, D) of B2 on a video path: the VAE's
    single-head mid attention at D 512 (the decode of the frames and, with
    `encode`, the encode of one image) and the UNet's spatial sites (CFG
    batch 2 x `frames`) that reach VITRON_FLASH_MIN (self-attention;
    cross-attention when the `n_ctx` context tokens do too), non-causal,
    shift 0, bf16 as `layers._mha` calls it."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    fmin = _flash_min()
    sites = [("vae decode", frames, lh * lw, lh * lw, 1, 512)]
    if encode:
        sites.append(("vae encode", 1, lh * lw, lh * lw, 1, 512))
    for e, n in sorted({(e, n) for e, n in video_plan(ucfg, lh, lw) if e[0] == "sattn"},
                       key=lambda en: -en[1]):
        if n >= fmin:
            sites.append((f"unet self-attention C={e[1]}", 2 * frames, n, n, e[2],
                          ucfg.head_dim))
        if n >= fmin and n_ctx >= fmin:
            sites.append((f"unet cross-attention C={e[1]}", 2 * frames, n, n_ctx, e[2],
                          ucfg.head_dim))
    return sites


def b7_shapes() -> list:
    """(B, F, N, C, heads) of B7's rows: the t2v plan's four temporal levels
    at 2 x VIDEO_FRAMES frames of VIDEO_LATENT (task D, phase 5b), then the
    i2vgen plan's at 2 x I2V_FRAMES frames of I2V_LATENT^2 (task G, 5d)."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import (Image2VideoConfig,
                                                                   Text2VideoConfig)

    t2v, i2v = Text2VideoConfig(), Image2VideoConfig()
    return ([(2, VIDEO_FRAMES, n, c, h) for n, c, h in video_sites(t2v.unet, *VIDEO_LATENT)]
            + [(2, I2V_FRAMES, n, c, h)
               for n, c, h in video_sites(i2v.unet, I2V_LATENT, I2V_LATENT)])


def frame_attention_row(torch, card: str, qkv32, heads: int, dtype) -> dict:
    """B7 against its plain version on q, k, v (float32 [B, F, N, C] tensors,
    cast to `dtype`), `heads` heads of C / heads: max |kernel - plain| /
    max |plain| (VIDEO_TOL), the same bits twice, device times from
    CUDA-graph replay of the kernel, the plain version and
    F.scaled_dot_product_attention on the [B N, H, F, D] copies (the layout
    copies made outside the timed region), and the bound."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import temporal_attention as ta

    b, f, n, c = qkv32[0].shape
    d = c // heads
    name = str(dtype).split(".")[-1]
    q, k, v = (t.to(dtype) for t in qkv32)
    got, again = (ta.frame_attention(q, k, v, heads, d ** -0.5) for _ in range(2))
    want = ta.frame_attention_plain(q, k, v, heads, d ** -0.5)
    err, rel = rel_err(got, want)
    same = bool(torch.equal(got, again))
    del again, want
    qt, kt, vt = (t.reshape(b, f, n, heads, d).permute(0, 2, 3, 1, 4)
                  .reshape(b * n, heads, f, d).contiguous() for t in (q, k, v))
    ms = graph_ms(torch, lambda: ta.frame_attention(q, k, v, heads, d ** -0.5))
    plain_ms = graph_ms(torch, lambda: ta.frame_attention_plain(q, k, v, heads, d ** -0.5),
                        calls=2)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    r = row(err, rel, ms, plain_ms, nbytes(q, k, v, got), 4 * b * n * heads * f * f * d,
            "fp32" if dtype == torch.float32 else "bf16_tensor", lib_ms)
    print(f"frame_attention [{b},{f},{n},{c}] heads={heads} D={d} {name}: rel_err={rel:.3e} "
          f"same bits twice={same}; kernel {ms:.4f} ms "
          f"({nbytes(q, k, v, got) / (ms * 1e-3) / 1e9:.0f} GB/s) plain {plain_ms:.4f} ms "
          f"{bound_text(r)} (scaled_dot_product_attention on [B N, H, F, D]; graph-replayed "
          f"device times) [{card}]", flush=True)
    check(rel <= VIDEO_TOL[name] and same,
          f"frame_attention [{b},{f},{n},{c}] {name}: rel err {rel}, same bits twice {same}")
    return r


def video_kernel_rows(torch, card: str, ucfg, vcfg, lh: int, lw: int, frames: int, n_ctx: int,
                      seed: int, encode_hw=None):
    """A video path's kernels against their plain versions at the shapes one
    CFG UNet call (batch 2 x `frames` of lh x lw latents, `n_ctx` context
    tokens) and its VAE give them, from the block plan and the VAE config:
    B6, B7 and B3 at each temporal-transformer level, B8 at every [B, R, C]
    of the UNet call, the decode of the frames and (with `encode_hw`) the
    encode of one image, B2 at the VAE decode's (and encode's) mid attention
    and at every spatial UNet attention site that reaches VITRON_FLASH_MIN,
    in bf16 as `layers._mha` calls it. Each row: error, device time of the kernel
    and of the library call (CUDA-graph replay) where one PyTorch call
    computes the same function (layout copies made outside the timed
    region), the plain version's (CUDA events where its float32 temporaries
    would fill a graph's pool), and the bound."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import geglu_ff as gf
    from vitron_tpu_torch.kernels import group_norm as gn
    from vitron_tpu_torch.kernels import temporal_conv as tc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {"tconv": [], "tattn": [], "geglu_video": [], "gn_video": [], "flash_vae": []}
    b, f = 2, frames
    f32, bf16 = torch.float32, torch.bfloat16

    def peak(dtype):
        return "fp32" if dtype == f32 else "bf16_tensor"

    for n, c, heads in video_sites(ucfg, lh, lw):
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

        qkv32 = [torch.randn((b, f, n, c), generator=g, device=dev) for _ in range(3)]
        for dtype in (f32, bf16):
            rows["tattn"].append(frame_attention_row(torch, card, qkv32, heads, dtype))
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

    # B8 at every shape of one CFG UNet call, of the decode of the frames and
    # of the encode of one image
    unet_gn = video_gn_shapes(ucfg, lh, lw, b, f)
    vae_gn = vae_decode_gn_shapes(vcfg, lh, lw, f)
    enc_gn = (vae_encode_gn_shapes(vcfg, *encode_hw, 1) if encode_hw
              else collections.Counter())
    enc_n, dec_n = vae_counts(vcfg, lh * lw)
    want_n = (video_counts(ucfg, lh, lw, n_ctx)["group_norm_sums"], dec_n["group_norm_sums"],
              enc_n["group_norm_sums"] if encode_hw else 0)
    check((sum(unet_gn.values()), sum(vae_gn.values()), sum(enc_gn.values())) == want_n,
          f"group-norm shapes {sum(unet_gn.values())}, {sum(vae_gn.values())}, "
          f"{sum(enc_gn.values())} != counts {want_n}")
    for shape in sorted(unet_gn.keys() | vae_gn.keys() | enc_gn.keys()):
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
            enc = f", x{enc_gn[shape]} an encode" if encode_hw else ""
            print(f"group_norm_sums {list(shape)} {name} (x{unet_gn[shape]} a UNet call, "
                  f"x{vae_gn[shape]} a decode{enc}; {gn._splits(*shape)} row splits): "
                  f"rel_err={rel:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms, same bits twice="
                  f"{bool(torch.equal(got, again))} {bound_text(r)} (kernel and library "
                  f"graph-replayed) [{card}]", flush=True)
            check(rel <= GN_TOL and bool(torch.equal(got, again)),
                  f"group_norm_sums {list(shape)} {name}: rel err {rel} or not deterministic")
            rows["gn_video"].append(r)
            del x, got, again, want
        del x32

    call = dict(causal=False, softmax_shift=0.0)
    for what, bb, s_len, t_len, nh, d in video_flash_sites(ucfg, lh, lw, frames, n_ctx,
                                                           encode_hw is not None):
        q = torch.randn((bb, s_len, nh, d), generator=g, device=dev).to(bf16)
        k, v = (torch.randn((bb, t_len, nh, d), generator=g, device=dev).to(bf16)
                for _ in range(2))
        got = fa.flash_attention(q, k, v, **call)
        want = fa.flash_attention_plain(q, k, v, **call)
        err, rel = rel_err(got, want)
        row_rel = flash_row_rel(got, want)
        del want
        ms = graph_ms(torch, lambda: fa.flash_attention(q, k, v, **call), calls=2)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **call), iters=3)
        flops = 4 * bb * nh * s_len * t_len * d
        r = dict(row(err, rel, ms, plain_ms, nbytes(q, k, v, got), flops, "bf16_tensor",
                     sdpa_ms(torch, q, k, v)), b2=f"{what} [{bb},{s_len},{nh},{d}]")
        print(f"flash_attention {what} [{bb},{s_len},{nh},{d}] keys {t_len} bf16 non-causal "
              f"shift 0: abs_err={err:.3e} rel_err={rel:.3e} row_rel_err={row_rel:.3e} kernel "
              f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, graph-replayed) plain "
              f"{plain_ms:.4f} ms {bound_text(r)} [{card}]", flush=True)
        check_flash(what, err, row_rel)
        rows["flash_vae"].append(r)
        del q, k, v, got
    return rows


def phase_conv3x3(torch, card: str):
    """B9 against its plain version, float32 and bf16, at every distinct
    eligible stride-1 3x3 conv (H, W, C, D) of the i2vgen UNet at task G's
    64x64 latents, batch 32 (CFG 2 x 16 frames), from the block plan. Each
    row: max |kernel - plain| / max |plain|, CUDA-event times of the kernel
    and the plain version, the bound (bytes of x, w and out once at
    3.35 TB/s, or 2 M 9C D FLOP at the bf16 tensor-core rate for both
    types: the products are bf16) and cuDNN's `F.conv2d` on the
    bf16-rounded x and w, channels-last, bf16 in and float32 sums. Then the
    VJP's dx (the kernel) and dw on the card against `conv3x3_vjp_plain` at
    a 32x32 level shape."""
    import torch.nn.functional as F

    from vitron_tpu_torch.kernels import conv2d as cv
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig, conv3x3_sites

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    bsz = 2 * I2V_FRAMES
    counts = conv3x3_sites(UNetSDVideoConfig.i2vgen_xl(), I2V_LATENT, I2V_LATENT)
    sites = sorted((s for s in counts if cv.eligible((bsz,) + s[:3], s[3], f32)),
                   key=lambda s: (-s[0], s[2], s[3]))
    rows = {"conv3x3": []}
    for h, w, c, d in sites:
        x32 = torch.randn((bsz, h, w, c), generator=g, device=dev)
        w32 = torch.randn((3, 3, c, d), generator=g, device=dev) / (9 * c) ** 0.5
        flops = 2 * bsz * h * w * 9 * c * d
        for dtype in (f32, bf16):
            name = str(dtype).split(".")[-1]
            x, k = x32.to(dtype), w32.to(dtype)
            got = cv.conv3x3_same(x, k)
            want = cv.conv3x3_plain(x, k)
            err, rel = rel_err(got, want)
            # cuDNN: NCHW views of channels-last bf16 copies (made outside the
            # timed region), bf16 in, float32 sums, bf16 out
            xc = x.to(bf16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            kc = k.to(bf16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib = F.conv2d(xc, kc, padding=1).permute(0, 2, 3, 1)
            _, lib_rel = rel_err(lib, want)
            ms = cuda_ms(torch, lambda: cv.conv3x3_same(x, k), iters=5, warmup=2)
            plain_ms = cuda_ms(torch, lambda: cv.conv3x3_plain(x, k), iters=3, warmup=1)
            lib_ms = cuda_ms(torch, lambda: F.conv2d(xc, kc, padding=1), iters=5, warmup=2)
            r = row(err, rel, ms, plain_ms, nbytes(x, k, got), flops, "bf16_tensor", lib_ms)
            print(f"conv3x3_same [{bsz},{h},{w},{c}] D={d} {name} (x{counts[(h, w, c, d)]} a "
                  f"UNet call): rel_err={rel:.3e} kernel {ms:.4f} ms "
                  f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s) plain {plain_ms:.4f} ms "
                  f"{bound_text(r)} (cuDNN F.conv2d bf16 channels-last "
                  f"{flops / (lib_ms * 1e-3) / 1e12:.1f} TFLOP/s, rel {lib_rel:.1e}) [{card}]",
                  flush=True)
            check(rel <= VIDEO_TOL[name], f"conv3x3_same {(h, w, c, d)} {name} rel err {rel}")
            rows["conv3x3"].append(r)
            del x, k, got, want, lib, xc, kc
        del x32, w32

    # the VJP at a level-1 shape: dx through the kernel, dw by products
    h, c, d = I2V_LATENT // 2, 1024, 1024
    for dtype in (f32, bf16):
        name = str(dtype).split(".")[-1]
        x = torch.randn((bsz, h, h, c), generator=g, device=dev).to(dtype)
        k = (torch.randn((3, 3, c, d), generator=g, device=dev) / (9 * c) ** 0.5).to(dtype)
        gy = torch.randn((bsz, h, h, d), generator=g, device=dev).to(dtype)
        with torch.enable_grad():
            xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
            n0 = cv.launches
            cv.conv3x3_same(xg, kg).backward(gy)
            torch.cuda.synchronize()
            launched = cv.launches - n0
        dx, dw = cv.conv3x3_vjp_plain(x, k, gy)
        _, rel_dx = rel_err(xg.grad, dx)
        _, rel_dw = rel_err(kg.grad, dw)
        print(f"conv3x3_same VJP [{bsz},{h},{h},{c}] D={d} {name}: dx rel_err={rel_dx:.3e}, dw "
              f"rel_err={rel_dw:.3e} against conv3x3_vjp_plain; {launched} launches (forward "
              f"and dx) [{card}]", flush=True)
        check(launched == 2 and rel_dx <= VIDEO_TOL[name] and rel_dw <= VIDEO_TOL[name],
              f"conv3x3_same VJP {name}: dx {rel_dx}, dw {rel_dw}, {launched} launches")
        del x, k, gy, xg, kg, dx, dw
    for name in ("float32", "bfloat16"):
        print_sums(f"conv3x3_same {name}", rows["conv3x3"][name == "bfloat16"::2], card)
    return rows


def phase_i2v_kernels(torch, card: str):
    """5d: the task-G path's kernels at its shapes: B6, B7 and B3 at the
    four levels of the i2vgen plan (2 x 16 frames of 64x64 latents) and B8
    at every [B, R, C] of one UNet call, of the 512^2 VAE encode and of the
    16-frame decode, float32 and bf16; B2 in bf16 (the only type
    `layers._mha` gives it) at D 512 (the encode's [1, 4096, 1, 512], the
    decode's [16, 4096, 1, 512]) and at D 64 (the 32x32 level's
    self-attention, [32, 1024, 16, 64])."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import Image2VideoConfig

    cfg = Image2VideoConfig()
    check(cfg.latent_size == I2V_LATENT and cfg.num_frames == I2V_FRAMES,
          f"Image2VideoConfig() latents {cfg.latent_size} x {cfg.num_frames} frames")
    rows = video_kernel_rows(torch, card, cfg.unet, cfg.vae, I2V_LATENT, I2V_LATENT, I2V_FRAMES,
                             i2v_context(cfg.unet, cfg.text.max_length), seed=14,
                             encode_hw=(cfg.size, cfg.size))
    for key, name in (("tconv", "B6"), ("tattn", "B7"), ("geglu_video", "B3"),
                      ("gn_video", "B8"), ("flash_vae", "B2")):
        print_sums(f"task-G shapes, {name}", rows[key], card)
    return {f"{k}_i2v": v for k, v in rows.items()}


def print_b2_rows(rs, card: str) -> None:
    """One line of B2's bf16 rows (every main path's type; `b2` is None on
    the float32 ones): each row's kernel ms beside
    F.scaled_dot_product_attention's on the same inputs."""
    bf = [r for r in rs if r["b2"]]
    faster = sum(r["ms"] < r["library_ms"] for r in bf)
    print("B2 bf16 rows, kernel ms / SDPA ms: "
          + "; ".join(f"{r['b2']} {r['ms']:.4f} / {r['library_ms']:.4f}" for r in bf)
          + f" ({faster} of {len(bf)} faster than SDPA) [{card}]", flush=True)


def print_sums(what: str, rs, card: str) -> None:
    """One line of a group of kernel rows: their summed kernel, bound,
    plain and library times."""
    lib = [r["library_ms"] for r in rs]
    bound = sum(max(r["bytes_ms"], r["ops_ms"]) for r in rs)
    lib_ms = "none" if None in lib else f"{sum(lib):.4f} ms"
    print(f"{what}: {len(rs)} rows, kernel {sum(r['ms'] for r in rs):.4f} ms, bound "
          f"{bound:.4f} ms, plain {sum(r['plain_ms'] for r in rs):.4f} ms, library {lib_ms}, "
          f"max rel err {max(r['rel'] for r in rs):.3e} [{card}]", flush=True)


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


def video_requests(torch, card: str, system, reply: str, task: str, want: dict,
                   shape: tuple, what: str, **media):
    """A routed video reply, twice, on `system`: launches equal to `want`
    each time, status ok with `task`, a uint8 video of `shape`,
    finite latent and decoded frames before the uint8 cast (recorded around
    `vae.decode`), non-constant frames, and the same frames both times.
    Returns (launches, the second request's seconds)."""
    from vitron_tpu_torch.models.diffusion import vae

    label = f"task {reply[len('<module>')]}"
    decoded = []
    decode = vae.decode

    def recorded_decode(params, vcfg, z):
        out = decode(params, vcfg, z)
        decoded.append((bool(torch.isfinite(z).all()), bool(torch.isfinite(out).all()),
                        z.float().std().item(), out.float().abs().max().item()))
        return out

    runs = []
    vae.decode = recorded_decode
    try:
        for i in range(2):
            reset_launches()
            out, t_req = timed_route(torch, system, reply, **media)
            launches = expect_launches(want, f"{label} run {i + 1}")
            check(out["status"] == "ok" and out["task"] == task,
                  f"{label}: status {out['status']}, {out.get('error')}")
            video = out["video"]
            z_ok, frames_ok, z_std, fmax = decoded[-1]
            check(video.shape == shape and video.dtype == np.uint8,
                  f"{label} video {video.shape} {video.dtype}")
            check(z_ok and frames_ok, f"{label}: non-finite latent or decoded frames")
            check(int(video.max()) != int(video.min()), f"{label}: the frames are constant")
            runs.append(video)
            print(f"{label} run {i + 1}: request {t_req:.3f} s ({what}), video "
                  f"{video.shape} mean {video.mean():.2f} std {video.std():.2f}; final latent std "
                  f"{z_std:.3f}, decoded max |x| {fmax:.3f} before the clamp, finite [{card}]",
                  flush=True)
    finally:
        vae.decode = decode
    check(np.array_equal(runs[0], runs[1]), f"{label}: two identical requests gave other frames")
    return launches, t_req


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
    torch.cuda.reset_peak_memory_stats()
    launches, t_req = video_requests(
        torch, card, system, TASK_D_REPLY, "video_generation", want,
        (cfg.num_frames, cfg.height, cfg.width, 3), f"{cfg.steps} DDIM-v steps")
    peak_mem = torch.cuda.max_memory_allocated()

    ids = pipe.tokenize(["a red car", ""])
    v_fn = pipe.v_fn(clip_text.encode(pipe.text_params, cfg.text, ids))
    g = torch.Generator(device=pipe.device).manual_seed(5)
    x = torch.randn((1, cfg.num_frames, lh, lw, cfg.unet.in_dim), generator=g,
                    device=pipe.device)
    unet_ms = cuda_ms(torch, lambda: v_fn(x, 501), iters=3, warmup=1)
    vae_ms = cuda_ms(torch, lambda: vae.decode(pipe.vae_params, cfg.vae, x[0]), iters=2,
                     warmup=1)
    profile_breakdown(torch, card, "task D: one float32 CFG UNet call",
                      lambda: v_fn(x, 501), unet_ms, VIDEO_KERNEL_GROUPS)
    print(f"task D: request {t_req:.3f} s ({cfg.steps} CFG UNet calls at {unet_ms:.2f} ms = "
          f"{cfg.steps * unet_ms / 1e3:.3f} s, VAE decode of {cfg.num_frames} frames "
          f"{vae_ms:.2f} ms, the rest {t_req - cfg.steps * unet_ms / 1e3 - vae_ms / 1e3:.3f} s), "
          f"peak memory {peak_mem / 2**30:.2f} GiB (float32 UNetSD_T2V, 320x576, "
          f"{cfg.num_frames} frames) [{card}]", flush=True)
    return launches


def build_i2v(torch, cfg, device, seed: int):
    """I2V pipeline (float32, random weights with every zero leaf filled) with
    a seeded stub image embedder, so the global tokens are live."""
    from vitron_tpu_torch.models.diffusion import clip_text, unet_sd_video, vae
    from vitron_tpu_torch.models.diffusion.synthetic import (StubClipTokenizer, StubImageEmbedder,
                                                             fill_zero_leaves)
    from vitron_tpu_torch.models.diffusion.video_pipelines import Image2VideoPipeline

    g = torch.Generator(device=device).manual_seed(seed)
    unet = fill_zero_leaves(unet_sd_video.init_params(g, cfg.unet, device), g)
    vae_p = fill_zero_leaves(vae.init_params(g, cfg.vae, device), g)
    text = fill_zero_leaves(clip_text.init_params(g, cfg.text, device), g)
    return Image2VideoPipeline(cfg, unet, vae_p, text,
                               tokenizer=StubClipTokenizer(cfg.text.vocab_size),
                               image_embedder=StubImageEmbedder(cfg.unet.y_dim, seed))


def phase_task_g(torch, card: str, pipe):
    """A routed task-G reply on a 480x640 image (resized to 512^2 on the
    host, C7), twice: the VAE encode of the image, `cfg.steps` DDIM-v steps
    of one CFG i2vgen UNet call each, then the VAE decode of the 16 frames.
    Identical frames both times, finite latent and decoded frames before the
    uint8 cast, non-constant frames, and launches of every kernel equal to
    the block plan's count x steps plus the VAE encode's and decode's (and
    none of B9, which no path calls). Then one CFG UNet call, one encode and
    one decode at the request's shapes, timed alone."""
    from vitron_tpu_torch.models.diffusion import clip_text, vae
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = pipe.cfg
    system = VitronSystem(None)
    system.register_image2video(pipe)
    ls = cfg.latent_size
    per_call = video_counts(cfg.unet, ls, ls, i2v_context(cfg.unet, cfg.text.max_length))
    enc, dec = vae_counts(cfg.vae, ls * ls)
    want = {k: cfg.steps * per_call[k] + enc.get(k, 0) + dec.get(k, 0) for k in per_call}
    image = np.random.RandomState(3).randint(0, 256, (480, 640, 3), np.uint8)
    torch.cuda.reset_peak_memory_stats()
    launches, t_req = video_requests(
        torch, card, system, TASK_G_REPLY, "image_to_video", want,
        (cfg.num_frames, cfg.size, cfg.size, 3),
        f"{cfg.steps} DDIM-v steps, a {image.shape[0]}x{image.shape[1]} image", image=image)
    peak_mem = torch.cuda.max_memory_allocated()

    ids, pixels, glob = pipe.prepare(image, "a boat on the sea")
    local = pipe.encode_image(pixels)
    v_fn = pipe.v_fn(clip_text.encode(pipe.text_params, cfg.text, ids), local, glob)
    g = torch.Generator(device=pipe.device).manual_seed(5)
    x = torch.randn((1, cfg.num_frames, ls, ls, cfg.unet.in_dim), generator=g,
                    device=pipe.device)
    unet_ms = cuda_ms(torch, lambda: v_fn(x, 501), iters=3, warmup=1)
    enc_ms = cuda_ms(torch, lambda: pipe.encode_image(pixels), iters=3, warmup=1)
    dec_ms = cuda_ms(torch, lambda: vae.decode(pipe.vae_params, cfg.vae, x[0]), iters=2,
                     warmup=1)
    profile_breakdown(torch, card, "task G: one float32 CFG i2vgen UNet call",
                      lambda: v_fn(x, 501), unet_ms, VIDEO_KERNEL_GROUPS)
    rest = t_req - cfg.steps * unet_ms / 1e3 - (enc_ms + dec_ms) / 1e3
    print(f"task G: request {t_req:.3f} s ({cfg.steps} CFG UNet calls at {unet_ms:.2f} ms = "
          f"{cfg.steps * unet_ms / 1e3:.3f} s, VAE encode of the {cfg.size}^2 image "
          f"{enc_ms:.2f} ms, decode of {cfg.num_frames} frames {dec_ms:.2f} ms, the rest "
          f"{rest:.3f} s), peak memory {peak_mem / 2**30:.2f} GiB (float32 UNetSD_I2VGen, "
          f"{cfg.size}x{cfg.size}, {cfg.num_frames} frames) [{card}]", flush=True)
    return launches


# device kernels of a video UNet call by what launched them: B2, the port's
# GEMM template (mode 1 = B6's temporal conv, 0 and 2 = B3's two products,
# plus its split-K reduction), B7, B8, cuDNN's convolutions, cuBLAS's
# products (projections, attention einsums), and the rest (PyTorch's
# elementwise and reduction kernels); the first pattern that matches counts
VIDEO_KERNEL_GROUPS = (
    ("B2 flash_attention", r"flash_fwd"),
    ("B6 temporal_conv_k3", r"gemm_(f32|bf16_tc)_kernel<1\b"),
    ("B3 geglu_ff", r"gemm_(f32|bf16_tc)_kernel<[02]\b|split_k_reduce"),
    ("B7 frame_attention", r"frame_attention_kernel"),
    ("B8 group_norm_sums", r"gn_sums_kernel|gn_split_reduce"),
    ("convolutions (cuDNN)", r"conv|implicit|cudnn|fprop|winograd"),
    ("products (cuBLAS)", r"gemm|cutlass"))


def profile_breakdown(torch, card: str, what: str, call, unprofiled_ms: float, kernel_groups):
    """Where one call's device time goes: a torch.profiler trace of the
    call, its kernels' device time summed by group (the first pattern of
    `kernel_groups` that matches a kernel's name) and by name, and the
    device's busy share of the unprofiled call."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
              if e.device_type == cuda}
    busy = sum(dev_ms.values())
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["the rest"] = 0.0
    for key, ms in dev_ms.items():
        name = next((n for n, pat in kernel_groups if re.search(pat, key)), "the rest")
        groups[name] += ms
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    print(f"{what} breakdown: {unprofiled_ms:.1f} ms unprofiled, device busy {busy:.1f} ms = "
          f"{busy / unprofiled_ms:.3f} of it (idle share {1 - busy / unprofiled_ms:.3f}); by "
          f"group (ms): " + "; ".join(f"{k} {v:.1f}" for k, v in groups.items()) + f" [{card}]",
          flush=True)
    print(f"{what} device time by kernel (ms): "
          + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top), flush=True)


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
    reset_launches()
    got = usv.forward(tree_map(lambda a: a.to(dev), params), cfg, x.to(dev), t.to(dev),
                      y=ctx.to(dev)).cpu()
    expect_launches(video_counts(cfg, 16, 16, 77), "video cpu-vs-card")
    rel = (got - want).abs().max().item() / want.abs().max().item()
    print(f"video cpu-vs-card: float32 t2v UNet (levels 512/1024, 8 frames, 16x16 latents) "
          f"rel_err={rel:.3e} (limit {CPU_GPU_TOL}), max |v| {want.abs().max().item():.3f} "
          f"[{card}]", flush=True)
    check(rel <= CPU_GPU_TOL, f"video UNet CPU and card disagree: {rel}")


def phase_i2v_cpu_vs_card(torch, card: str):
    """One float32 CFG-batch call of the i2vgen UNet at its real widths but
    reduced depth (two levels, 512 and 1024 channels), 8 frames and 16x16
    latents (the local-image stream keeps its fixed 32x32 pool, here
    upsampling), with text, local and global conditioning, on the CPU and on
    the card: B6 at C 512/1024, B7 at 8 and 16 heads, B3 at C 512/1024, B8
    on the card; no flash site (8x8 is the attention level)."""
    from vitron_tpu_torch.models.diffusion import unet_sd_video as usv
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = usv.UNetSDVideoConfig.i2vgen_xl(dim_mult=(1, 2))
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(15)
    params = fill_zero_leaves(usv.init_params(g, cfg, cpu), g)
    x = torch.randn((2, 8, 16, 16, 4), generator=g)
    t = torch.tensor([501.0, 501.0])
    fps = torch.tensor([16.0, 16.0])
    ctx = torch.randn((2, 77, cfg.context_dim), generator=g)
    glob = torch.randn((1, cfg.y_dim), generator=g)
    image = torch.cat([glob, torch.zeros_like(glob)])
    local = torch.randn((1, 16, 16, 4), generator=g).expand(2, 16, 16, 4).contiguous()
    args = dict(y=ctx, fps=fps, image=image, local_image=local)
    t0 = time.perf_counter()
    want = usv.forward(params, cfg, x, t, **args)
    print(f"i2v cpu-vs-card: cpu forward {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    reset_launches()
    got = usv.forward(tree_map(lambda a: a.to(dev), params), cfg, x.to(dev), t.to(dev),
                      **{k: v.to(dev) for k, v in args.items()}).cpu()
    n_ctx = i2v_context(cfg, 77)
    counts = expect_launches(video_counts(cfg, 16, 16, n_ctx), "i2v cpu-vs-card")
    tol = UNET_CPU_GPU_TOL["flash" if counts["flash_attention"] else "einsum"]
    rel = (got - want).abs().max().item() / want.abs().max().item()
    print(f"i2v cpu-vs-card: float32 i2vgen UNet (levels 512/1024, 8 frames, 16x16 latents, "
          f"{n_ctx} context tokens) rel_err={rel:.3e} (limit {tol}), "
          f"max |v| {want.abs().max().item():.3f} [{card}]", flush=True)
    check(rel <= tol, f"i2v UNet CPU and card disagree: {rel}")


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def random_int4_llm(torch, params, gen, device, scale=None, zero_mean=False):
    """Replace the 7 projections and lm_head with random packed int4: bytes
    uniform in [-128, 128), as the JAX package's bench makes them. scale
    None gives each weight the init's std 1/sqrt(fan_in) (a uniform nibble
    has std 4.61); the bench's fixed 2e-2 is ~6x that at Vicuna-7B width.
    zero_mean draws each nibble from [-7, 7] instead (std 4.32), as
    `quantize_int4` emits them: a uniform byte's nibbles average -0.5, which
    puts one offset on every output of a projection, and through the
    residual stream that makes the second layer's attention amplify
    rounding (PERF.md §6)."""
    llm = params["llm"]

    def qw(w):
        packed = tuple(w.shape[:-2]) + (w.shape[-2] // 2, w.shape[-1])
        if zero_mean:
            lo, hi = (torch.randint(-7, 8, packed, generator=gen, dtype=torch.int16,
                                    device=device) for _ in range(2))
            q4, std = (((hi & 0xF) << 4) | (lo & 0xF)).to(torch.uint8).view(torch.int8), 4.32
        else:
            q4 = torch.randint(-128, 128, packed, generator=gen, dtype=torch.int8, device=device)
            std = 4.61
        s = scale if scale is not None else 1.0 / (std * w.shape[-2] ** 0.5)
        return {"q4": q4, "s": torch.full(tuple(w.shape[:-2]) + (1, w.shape[-1]), s,
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
    reset_launches()
    out1, t_req = timed_chat(torch, system, image, sampling)
    peak = torch.cuda.max_memory_allocated()
    gen_ = system.engine.generator
    logits = gen_.last_prefill_logits
    tokens1 = out1["reply"]["tokens"]
    n_layers = cfg.llm.num_layers
    per_forward = 7 * n_layers + 1
    # int4: prefill + one forward per decode step; flash: the prefill's layers
    launches = expect_launches({"int4_matmul": per_forward * NEW_TOKENS,
                                "flash_attention": n_layers}, "slice")
    print(f"slice: status={out1['status']} tokens={len(tokens1)} prefill logits "
          f"{tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())}", flush=True)
    check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    check(len(tokens1) == NEW_TOKENS, f"{len(tokens1)} tokens, expected {NEW_TOKENS}")

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


# ------------------------------------------------------------------ training

TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|
TRAIN_SEQ = 2048     # pad_len: the recipe's model_max_length
TRAIN_BATCH = 2      # the recipe's 16 (trainer.py:46) cut for the smoke's time
TRAIN_STEPS = 4
TRAIN_REMAT = False  # per-layer recomputation; on when a step's peak would pass ~70 GB
TRAIN_LOSS_RTOL = 1e-6  # the same step twice from the same state
TRAIN_CPU_GPU_TOL = {"loss": 1e-4, "grad": 1e-3}  # grad: max |card - cpu| / max |cpu|
# question and answer lengths in words (DemoTokenizer: a token a word): with
# the 256 image tokens a row fills 1,490-1,900 of the 2,048 slots
TRAIN_WORDS = (200, 350, 1000, 1250)
TRAIN_KERNEL_GROUPS = (
    ("B1 int4_matmul", r"int4_(gemm|gemm_tc|gemv|split_reduce)_kernel"),
    ("B2 flash forward", r"flash_fwd"),
    ("B5a flash dK/dV", r"flash_bwd_kv"),
    ("B5b flash dQ", r"flash_bwd_q"),
    ("products (cuBLAS)", r"gemm|cutlass|xmma"))
TRAIN_FLASH_CASES = [  # name, B, S, T, N, KH, D, q_offset, causal, valid slots of each row
    ("slice", 2, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 128, 0, True, (1893, 1610)),
    ("gqa", 2, 1024, 1536, 32, 8, 128, 512, True, (1536, 1402)),
    ("non-causal-d64", 2, 1024, 1024, 16, 16, 64, 0, False, (1024, 899)),
]


def b2_shapes() -> list:
    """Every shape the smoke holds B2 at, in the order of its phases (3, 4,
    5b, 18, 5d): a label, the shape (B, S, T, N, KH, D), q_offset, causal,
    the valid key slots of each batch row (None: no kv_mask), softmax_shift,
    whether the LSE is returned, and the input type. `tools/flash_rows.py`
    times these."""
    from vitron_tpu_torch.models.diffusion.video_pipelines import (Image2VideoConfig,
                                                                   Text2VideoConfig)

    def shape(label, b, s, t, n, kh, d, off=0, causal=False, valid=None, shift=0.0, lse=False,
              dtype="bfloat16"):
        return dict(label=label, b=b, s=s, t=t, n=n, kh=kh, d=d, q_offset=off, causal=causal,
                    valid=valid, shift=shift, lse=lse, dtype=dtype)

    out = [shape(f"chat {name} [1,{s},{n},128]", 1, s, t, n, kh, 128, off, True, (n_valid,),
                 None)
           for name, s, t, n, kh, off, n_valid in CHAT_FLASH_CASES]
    out += [shape(f"gligen [{b},{s},{n},{d}]", b, s, s, n, n, d)
            for b, s, n, d in GLIGEN_FLASH_SHAPES]
    t2v = Text2VideoConfig()
    out += [shape(f"task D {what} [{b},{s},{n},{d}]", b, s, t, n, n, d)
            for what, b, s, t, n, d in video_flash_sites(t2v.unet, *VIDEO_LATENT, VIDEO_FRAMES,
                                                         t2v.text.max_length, False)]
    out += [shape(f"train {name} [{b},{s},{n},{d}]", b, s, t, n, kh, d, off, causal, valid,
                  None, True, dtype)
            for dtype in ("bfloat16", "float32")
            for name, b, s, t, n, kh, d, off, causal, valid in TRAIN_FLASH_CASES]
    i2v = Image2VideoConfig()
    out += [shape(f"task G {what} [{b},{s},{n},{d}]", b, s, t, n, n, d)
            for what, b, s, t, n, d in video_flash_sites(
                i2v.unet, I2V_LATENT, I2V_LATENT, I2V_FRAMES,
                i2v_context(i2v.unet, i2v.text.max_length), True)]
    return out


def train_step_launches(llm_cfg) -> dict:
    """Kernel launches of one training step of the LLM: every projection and
    the lm_head on B1 and every layer's attention on B2 in the forward (both
    again under remat), B5a and B5b once a layer in the backward."""
    again = 2 if llm_cfg.remat else 1
    n = llm_cfg.num_layers
    return {"int4_matmul": 7 * n * again + 1, "flash_attention": n * again,
            "flash_attention_bwd_kv": n, "flash_attention_bwd_q": n}


def sdpa_bwd_ms(torch, q, k, v, attn_mask, dout) -> float:
    """F.scaled_dot_product_attention's backward on the same [B, S, N, D]
    inputs: CUDA-event time of forward + backward minus the forward's (both
    with grad on, so the forward keeps what its backward needs)."""
    import torch.nn.functional as F

    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True) for a in (q, k, v))
    gt = dout.transpose(1, 2)
    gqa = q.shape[2] != k.shape[2]

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask, enable_gqa=gqa)

    with torch.enable_grad():
        both = cuda_ms(torch, lambda: torch.autograd.grad(fwd(), (qt, kt, vt), gt), iters=5)
        fwd_only = cuda_ms(torch, fwd, iters=5)
    return both - fwd_only


def phase_train_kernels(torch, card: str):
    """B2 with its LSE, B5a and B5b against their plain versions at the
    trainer's attention shape [2, 2048, 32, 128] (causal, right-padded),
    a GQA row with q_offset > 0 and a non-causal D 64 row, in bf16 and f32;
    then B1 at the trainer's M = 4096 rows and the four (K, N) pairs."""
    from vitron_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows = {"flash_lse": [], "bwd_kv": [], "bwd_q": [], "int4_train": []}
    for name, b, s_len, t_len, nh, kh, d, off, causal, valid in TRAIN_FLASH_CASES:
        mask = torch.zeros((b, t_len), dtype=torch.bool, device=dev)
        for i, n_valid in enumerate(valid):
            mask[i, :n_valid] = True
        visible = fa._visible(b, s_len, t_len, dev, mask, off, causal)[:, 0, 0]  # [B, S, T]
        pairs = int(visible.sum()) * nh  # (query row, key) pairs the kernels compute
        scale = 1.0 / d ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            tn = str(dtype).split(".")[1]
            peak = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
            q, dout = (torch.randn((b, s_len, nh, d), generator=g, device=dev).to(dtype)
                       for _ in range(2))
            k, v = (torch.randn((b, t_len, kh, d), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            args = (q, k, v, mask, off, scale, causal)
            out, lse = fa._forward(*args, None, True)
            out2, lse2 = fa._forward(*args, None, True)
            want_out, want_lse = fa.flash_attention_plain(*args, None, return_lse=True)
            delta = fa._delta(out, dout)
            dk, dv = fa.flash_attention_bwd_kv(*args, out, lse, dout, delta)
            dq = fa.flash_attention_bwd_q(*args, out, lse, dout, delta)
            dk2, dv2 = fa.flash_attention_bwd_kv(*args, out, lse, dout, delta)
            dq2 = fa.flash_attention_bwd_q(*args, out, lse, dout, delta)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in
                       ((out, out2), (lse, lse2), (dk, dk2), (dv, dv2), (dq, dq2)))
            want_dk, want_dv = fa.flash_attention_bwd_kv_plain(*args, out, lse, dout)
            want_dq = fa.flash_attention_bwd_q_plain(*args, out, lse, dout)
            live = want_lse > -1e30
            row_rel = flash_row_rel(out, want_out)
            bwd_rows = {what: flash_row_rel(x, y, FLASH_BWD_ROW_FLOOR) for what, x, y in
                        (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))}
            errs = {"out": rel_err(out, want_out), "lse": rel_err(lse[live], want_lse[live]),
                    "dq": rel_err(dq, want_dq), "dk": rel_err(dk, want_dk),
                    "dv": rel_err(dv, want_dv)}
            ms_fwd = cuda_ms(torch, lambda: fa._forward(*args, None, True), iters=10)
            ms_kv = cuda_ms(torch, lambda: fa.flash_attention_bwd_kv(*args, out, lse, dout,
                                                                     delta), iters=10)
            ms_q = cuda_ms(torch, lambda: fa.flash_attention_bwd_q(*args, out, lse, dout,
                                                                   delta), iters=10)
            plain_fwd = cuda_ms(torch, lambda: fa.flash_attention_plain(
                *args, None, return_lse=True), iters=3, warmup=1)
            plain_kv = cuda_ms(torch, lambda: fa.flash_attention_bwd_kv_plain(
                *args, out, lse, dout), iters=3, warmup=1)
            plain_q = cuda_ms(torch, lambda: fa.flash_attention_bwd_q_plain(
                *args, out, lse, dout), iters=3, warmup=1)
            lib_bwd = sdpa_bwd_ms(torch, q, k, v, visible[:, None], dout)
            lib_fwd = sdpa_ms(torch, q, k, v, visible[:, None])
            row_fwd = dict(row(max(errs["out"][0], errs["lse"][0]),
                               max(errs["out"][1], errs["lse"][1]), ms_fwd, plain_fwd,
                               nbytes(q, k, v, mask, out, lse), 4 * d * pairs, peak, lib_fwd),
                           b2=f"train {name}" if dtype == torch.bfloat16 else None)
            # B5a does 4 of the backward's products (scores, dP, dV, dK), B5b 3
            # (scores, dP, dQ); the SDPA backward (dq, dk, dv in one call)
            # stands beside B5a + B5b and is written on B5a's row
            row_kv = row(max(errs["dk"][0], errs["dv"][0]), max(errs["dk"][1], errs["dv"][1]),
                         ms_kv, plain_kv, nbytes(q, k, v, mask, dout, lse, delta, dk, dv),
                         4 * 2 * d * pairs, peak, lib_bwd)
            row_q = row(errs["dq"][0], errs["dq"][1], ms_q, plain_q,
                        nbytes(q, k, v, mask, dout, lse, delta, dq), 3 * 2 * d * pairs, peak)
            five = max(nbytes(q, k, v, mask, out, dout, lse, dq, dk, dv) / HBM_BYTES_PER_S,
                       5 * 2 * d * pairs / PEAK_FLOPS[peak]) * 1e3
            seven_tflops = 7 * 2 * d * pairs / ((ms_kv + ms_q) * 1e-3) / 1e12
            print(f"train flash {name} {tn} B={b} S={s_len} T={t_len} N={nh} K={kh} D={d} "
                  f"q_offset={off} causal={causal}: rel_err "
                  + " ".join(f"{k_}={e[1]:.3e}" for k_, e in errs.items())
                  + f" (limit {TRAIN_TOL[tn]}), out row_rel_err={row_rel:.3e} (limit "
                  f"{FLASH_ROW_REL}), row_rel_err "
                  + " ".join(f"{k_}={e:.3e}" for k_, e in bwd_rows.items())
                  + f" (limit {FLASH_BWD_ROW_REL[tn]}), same bits twice={same}; B2+LSE "
                  f"{ms_fwd:.4f} ms "
                  f"({4 * d * pairs / (ms_fwd * 1e-3) / 1e12:.1f} TFLOP/s) plain "
                  f"{plain_fwd:.4f} {bound_text(row_fwd)}; B5a {ms_kv:.4f} ms plain "
                  f"{plain_kv:.4f} {bound_text(row_kv)}; B5b {ms_q:.4f} ms plain {plain_q:.4f} "
                  f"{bound_text(row_q)}; B5a+B5b {ms_kv + ms_q:.4f} ms ({seven_tflops:.1f} "
                  f"TFLOP/s of the seven products) against the five products' bound "
                  f"{five:.4f} ms and the SDPA backward {lib_bwd:.4f} ms [{card}]", flush=True)
            check(all(e[1] <= TRAIN_TOL[tn] for e in errs.values()),
                  f"train flash {name} {tn}: {errs}")
            check(all(e <= FLASH_BWD_ROW_REL[tn] for e in bwd_rows.values()),
                  f"train flash {name} {tn}: backward row rel errors {bwd_rows} (limit "
                  f"{FLASH_BWD_ROW_REL[tn]})")
            check_flash(f"train {name} {tn}", errs["out"][0], row_rel)
            check(same, f"train flash {name} {tn}: two runs gave other bits")
            rows["flash_lse"].append(row_fwd)
            rows["bwd_kv"].append(row_kv)
            rows["bwd_q"].append(row_q)
            del q, k, v, dout, out, lse, out2, lse2, dq, dk, dv, dq2, dk2, dv2
            del want_out, want_lse, want_dq, want_dk, want_dv
            torch.cuda.empty_cache()

    m = TRAIN_BATCH * TRAIN_SEQ
    for k, n in INT4_SHAPES:
        rows["int4_train"].append(int4_row(torch, card, g, m, k, n, iters=5))
        torch.cuda.empty_cache()
    print_sums(f"B1 at M {m}", rows["int4_train"], card)
    return rows


def train_dataset(path, n: int, seed: int, words):
    """A JSON of n image conversations in DemoTokenizer words: a question of
    words[0]-words[1] words and an answer of words[2]-words[3]."""
    rs = np.random.RandomState(seed)

    def text(lo, hi):
        return " ".join(f"w{x}" for x in rs.randint(0, 5000, rs.randint(lo, hi)))

    items = [{"conversations": [{"from": "human", "value": "<image>\n" + text(*words[:2])},
                                {"from": "gpt", "value": text(*words[2:])}],
              "image": f"img_{i}.png"} for i in range(n)]
    path.write_text(json.dumps(items))
    return path


def train_media_loader(seed: int, size: int):
    """kind, path -> a random 336x336 image (from seed and the file's index)
    through the port's preprocessing ([size, size, 3] float32)."""
    from vitron_tpu_torch.media.preprocess import preprocess_image

    def load(kind, path):
        i = int(path.rsplit("_", 1)[1].split(".")[0])
        pixels = np.random.RandomState(seed + i).randint(0, 256, (336, 336, 3), np.uint8)
        return preprocess_image(pixels, size)

    return load


def int4_dequant_ms(torch, llm) -> float:
    """Device time, over one training step, of the int4 backward's
    dequantize (`Int4Matmul.backward`: unpack_int4, the scale, the cast to
    bf16, in plain torch: elementwise kernels that a profile counts in "the
    rest"): CUDA events on one layer's seven packed projections, times the
    layer count, and on the lm_head."""
    from vitron_tpu_torch.kernels import int4_matmul as i4

    def ms(q4, s):
        return cuda_ms(torch, lambda: (i4.unpack_int4(q4).to(torch.float32) * s)
                       .to(torch.bfloat16), iters=3, warmup=1)

    layers = llm["layers"]
    per_layer = sum(ms(layers[t]["q4"][0], layers[t]["s"][0])
                    for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"))
    return layers["wq"]["q4"].shape[0] * per_layer + ms(llm["lm_head"]["q4"], llm["lm_head"]["s"])


def phase_train(torch, card: str):
    """The LoRA trainer at full width: Trainer.fit on VitronConfig.serving
    (Vicuna-7B, packed int4 projections and lm_head, flash attention;
    bf16 ViT-L/14), LoRA r 128 over the seven targets plus the projector and
    the region extractor, AdamW with warmup-cosine, TRAIN_BATCH rows of
    TRAIN_SEQ, TRAIN_STEPS steps, twice from the same state."""
    import gc
    import pathlib
    import tempfile

    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.train.data import SupervisedDataset
    from vitron_tpu_torch.train.trainer import TrainConfig, Trainer, make_lora_train_step

    dev = torch.device("cuda")
    cfg = VitronConfig.serving(llm=LlamaConfig.vicuna_7b(
        attn_impl="flash", max_seq_len=TRAIN_SEQ, remat=TRAIN_REMAT))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    base = random_int4_llm(torch, vitron_model.init_params(gen, cfg, dev), gen, dev)
    del base["video_tower"]  # image conversations only
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"train: Vicuna-7B int4 + ViT-L/14 bf16 random weights built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tc = TrainConfig(batch_size=TRAIN_BATCH, pad_len=TRAIN_SEQ, save_steps=10 ** 9)

    class CountingTrainer(Trainer):
        """Records each batch's real and supervised token counts."""

        def _build_batch(self, *a, **kw):
            batch = super()._build_batch(*a, **kw)
            self.tokens.append((int(batch["attn_mask"].sum()),
                                int((batch["labels"] != -100).sum())))
            return batch

    def run(tmp):
        tr = CountingTrainer(cfg, tc, base, str(pathlib.Path(tmp) / "out"),
                             gen=torch.Generator(device=dev).manual_seed(1))
        tr.tokens = []
        proj0 = tr.trainable["projector"]["w2"].detach().clone()
        seen, clock = [], [time.perf_counter()]

        def after_step(step, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            b_max = max(float(ab["b"].detach().abs().max())
                        for ab in tr.trainable["lora"].values())
            moved = not torch.equal(tr.trainable["projector"]["w2"], proj0)
            seen.append((step, loss, now - clock[0], b_max, moved))
            clock[0] = now

        ds = SupervisedDataset(str(train_dataset(pathlib.Path(tmp) / "train.json",
                                                 TRAIN_BATCH * TRAIN_STEPS, 0, TRAIN_WORDS)),
                               DemoTokenizer(), model_max_length=TRAIN_SEQ)
        t_fit = time.perf_counter()
        losses = tr.fit(ds, train_media_loader(100, cfg.image_tower.image_size),
                        total_steps=TRAIN_STEPS, log_every=10 ** 9, callback=after_step)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        return tr, losses, seen, fit_s

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tr, losses, seen, fit_s = run(tmp)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        tokens = tr.tokens
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        tr2, losses2, _, _ = run(tmp)
        step_fn = make_lora_train_step(cfg, tc, tr2.optimizer)
        ds = SupervisedDataset(str(pathlib.Path(tmp) / "train.json"), DemoTokenizer(),
                               model_max_length=TRAIN_SEQ)
        loader = train_media_loader(100, cfg.image_tower.image_size)

        def one_step():
            step_fn(tr2.trainable, base, tr2._build_batch(ds, [0, 1], loader, None))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        profile_breakdown(torch, card, "train: one LoRA step (2 x 2048)", one_step,
                          (time.perf_counter() - t0) * 1e3, TRAIN_KERNEL_GROUPS)
        print(f"train: of the profile's 'the rest', B1's backward dequantize (plain torch "
              f"in Int4Matmul.backward) takes {int4_dequant_ms(torch, base['llm']):.1f} ms a "
              f"step (CUDA events at the step's 225 weight shapes) [{card}]", flush=True)
        del tr2, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    per_step = train_step_launches(cfg.llm)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    step_s = [x[2] for x in seen[1:]]  # steps 2..: the first holds the optimizer's set-up
    mean_s = statistics.mean(step_s)
    tok_s = statistics.mean(t for t, _ in tokens[1:]) / mean_s
    for step, loss, sec, b_max, moved in seen:
        print(f"train: step {step} loss {loss:.6f} {sec:.3f} s, max |lora b| {b_max:.3e}, "
              f"projector moved {moved}", flush=True)
    print(f"train: losses {losses} then {losses2}; launches {launches} (expected {want}: "
          f"{per_step} a step); step {mean_s:.3f} s (steps 2-{TRAIN_STEPS}: "
          f"{', '.join(f'{x:.3f}' for x in step_s)}), {tok_s:.1f} trained tokens/s "
          f"(real tokens a step {[t for t, _ in tokens]}, supervised {[l for _, l in tokens]}),"
          f" fit {fit_s:.1f} s with the final save, peak memory {peak / 2**30:.2f} GiB, "
          f"remat {cfg.llm.remat} [{card}]", flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(losses2)), "training losses not finite")
    check(all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b) for a, b in zip(losses, losses2)),
          f"the same steps twice gave other losses: {losses} vs {losses2}")
    check(seen[0][3] == 0.0 and not seen[0][4],
          "step 1 (learning rate 0 at the warmup's start) moved the LoRA b or the projector")
    check(seen[1][3] > 0.0 and seen[1][4], "step 2 left the LoRA b or the projector unmoved")
    check(all(launches[k] == v for k, v in {"conv3x3_same": 0, **want}.items()),
          f"training launches {launches} != {want}")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def fan_in_scaled(tower):
    """A random tower with its stacked [L, in, out] matrices rescaled from
    the init's N(0, 1/L) (`dense_init` takes shape[0] as the fan-in, as the
    JAX package does) to N(0, 1/in). At the init's scale the random ViT-L is
    chaotic: float32 rounding in another order moves its features far more
    than rounding, so no two devices could agree downstream of it."""
    def fix(t):
        return t * (t.shape[0] / t.shape[1]) ** 0.5 if t.dim() == 3 else t

    return {**tower, "layers": tree_map(fix, tower["layers"])}


def train_cpu_vs_card_setup(torch):
    """(cfg, params, trainable, train config) of the training CPU-vs-card
    check, built on the CPU from a CPU generator: Vicuna-7B at full width
    cut to 2 layers, float32, zero-mean random int4 projections and lm_head;
    the ViT-L/14 at full depth with fan-in-scaled weights (`fan_in_scaled`);
    float32 LoRA factors with B nonzero (B = 0 would make every dA zero)."""
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.train.lora import init_lora_params
    from vitron_tpu_torch.train.trainer import TrainConfig

    f32, cpu = torch.float32, torch.device("cpu")
    cfg = VitronConfig(
        llm=LlamaConfig.vicuna_7b(num_layers=2, attn_impl="flash", max_seq_len=1024,
                                  param_dtype=f32, compute_dtype=f32),
        image_tower=ViTConfig.clip_vit_l14(), video_tower=ViTConfig.video_vit_l14())
    gen = torch.Generator().manual_seed(11)
    params = random_int4_llm(torch, vitron_model.init_params(gen, cfg, cpu), gen, cpu,
                             zero_mean=True)
    del params["video_tower"]  # image conversations only
    params["image_tower"] = fan_in_scaled(params["image_tower"])
    tc = TrainConfig(batch_size=2, pad_len=512, save_steps=10 ** 9)
    lora = {name: {"a": ab["a"].to(f32), "b": 0.02 * torch.randn(ab["b"].shape, generator=gen)}
            for name, ab in init_lora_params(gen, params["llm"], tc.lora).items()}
    return cfg, params, {"lora": lora, "projector": params["projector"],
                         "region": params["region"]}, tc


def phase_train_cpu_vs_card(torch, card: str):
    """One LoRA step's loss and gradients on the CPU and the card, from the
    same CPU-built state (`train_cpu_vs_card_setup`), at pad_len 512."""
    import pathlib
    import tempfile

    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.train.data import SupervisedDataset
    from vitron_tpu_torch.train.train_step import named_leaves
    from vitron_tpu_torch.train.trainer import Trainer, make_lora_loss

    cfg, params, trainable, tc = train_cpu_vs_card_setup(torch)
    losses, grads = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = SupervisedDataset(str(train_dataset(pathlib.Path(tmp) / "d.json", 2, 1,
                                                 words=(40, 60, 100, 140))),
                               DemoTokenizer(), model_max_length=512)
        for name, device in (("cuda", torch.device("cuda")), ("cpu", torch.device("cpu"))):
            p = tree_map(lambda a: a.to(device), params)
            tr = Trainer(cfg, tc, p, tmp, trainable=tree_map(lambda a: a.to(device), trainable))
            batch = tr._build_batch(ds, [0, 1], train_media_loader(200, cfg.image_tower.image_size),
                                    None)
            if name == "cuda":
                reset_launches()
            t0 = time.perf_counter()
            with torch.enable_grad():
                loss = make_lora_loss(cfg, tc)(tr.trainable, p, batch)
                loss.backward()
            if name == "cuda":
                torch.cuda.synchronize()
                launches = read_launches()
            losses[name] = float(loss.detach())
            grads[name] = {".".join(path): t.grad.float().cpu()
                           for path, t in named_leaves(tr.trainable) if t.grad is not None}
            print(f"train cpu-vs-card: {name} loss and gradients {time.perf_counter() - t0:.1f} s",
                  flush=True)
            del p, tr, batch, loss
    want = train_step_launches(cfg.llm)
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    check(grads["cuda"].keys() == grads["cpu"].keys(), "the two sides hold other gradients")
    grad_rel = {k: ((grads["cuda"][k] - g).abs().max() / g.abs().max()).item()
                for k, g in grads["cpu"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"train cpu-vs-card: 2-layer full-width float32 LoRA step at pad_len 512, loss "
          f"{losses['cpu']:.6f} rel_err={loss_rel:.3e} (limit {TRAIN_CPU_GPU_TOL['loss']}), "
          f"{len(grad_rel)} gradients, worst {worst} rel_err={grad_rel[worst]:.3e}, median "
          f"{statistics.median(grad_rel.values()):.3e} (limit {TRAIN_CPU_GPU_TOL['grad']}), "
          f"region extractor gradient "
          f"{'absent' if not any(k.startswith('region') for k in grad_rel) else 'present'}; "
          f"launches {launches} (expected {want}) [{card}]", flush=True)
    check(loss_rel <= TRAIN_CPU_GPU_TOL["loss"], f"training loss CPU vs card: {loss_rel}")
    check(grad_rel[worst] <= TRAIN_CPU_GPU_TOL["grad"], f"gradient {worst}: {grad_rel[worst]}")
    check(all(launches[k] == v for k, v in want.items()),
          f"cpu-vs-card launches {launches} != {want}")


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
        rows.update(phase_conv3x3(torch, card))
        rows.update(phase_i2v_kernels(torch, card))
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
        from vitron_tpu_torch.models.diffusion.video_pipelines import Image2VideoConfig

        t0 = time.perf_counter()
        pipe = build_i2v(torch, Image2VideoConfig(steps=TASK_G_STEPS), dev, seed=0)
        torch.cuda.synchronize()
        n_unet = sum(t.numel() for t in tree_leaves(pipe.unet_params))
        print(f"i2v: UNetSD_I2VGen ({n_unet / 1e9:.3f}B params), SD VAE, CLIP text (1024 wide), "
              f"float32 random weights and a stub image embedder built on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        task_g = phase_task_g(torch, card, pipe)
        del pipe
        torch.cuda.empty_cache()
        phase_video_unet_bf16(torch, card, dev)
        phase_video_cpu_vs_card(torch, card)
        phase_i2v_cpu_vs_card(torch, card)
    train_rows = phase_train_kernels(torch, card)
    rows["flash"] += train_rows.pop("flash_lse")
    rows["int4"] += train_rows.pop("int4_train")
    rows.update(train_rows)
    train = phase_train(torch, card)
    phase_train_cpu_vs_card(torch, card)

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
        return {"chat": chat[name], "task_a": task_a[name], "task_c": task_c[name],
                "task_b": task_b[name], "task_e": task_e[name], "task_c_seem": task_c_seem[name],
                "task_d": task_d[name], "task_g": task_g[name], "train": train[name]}

    rows["flash"] += rows.pop("flash_gligen") + rows.pop("flash_vae") + rows.pop("flash_vae_i2v")
    print_b2_rows(rows["flash"], card)
    rows["geglu"] += rows.pop("geglu_video") + rows.pop("geglu_video_i2v")
    rows["gn"] += rows.pop("gn_video") + rows.pop("gn_video_i2v")
    rows["tconv"] += rows.pop("tconv_i2v")
    rows["tattn"] += rows.pop("tattn_i2v")
    print(json.dumps({"kernels": [
        dict(entry("int4_matmul", "vitron_tpu_torch/csrc/int4_matmul.cu",
                   "vitron_tpu/kernels/int4_matmul.py:108", "int4", chat["int4_matmul"],
                   paths("int4_matmul")),
             reference_ms=sum(r["ref_ms"] for r in rows["int4"]),
             reference_is="torch.matmul of x with the weight dequantized to bf16 beforehand, "
                          "summed over the same rows: other inputs (four times the weight "
                          "bytes), not a port and not a library call of this function"),
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
        dict(entry("flash_attention_bwd_kv", "vitron_tpu_torch/csrc/flash_attention_bwd.cu",
                   "vitron_tpu/kernels/flash_attention.py:429", "bwd_kv",
                   train["flash_attention_bwd_kv"], paths("flash_attention_bwd_kv")),
             library_is="F.scaled_dot_product_attention's backward (dq, dk and dv in one "
                        "call), beside B5a + B5b"),
        dict(entry("flash_attention_bwd_q", "vitron_tpu_torch/csrc/flash_attention_bwd.cu",
                   "vitron_tpu/kernels/flash_attention.py:450", "bwd_q",
                   train["flash_attention_bwd_q"], paths("flash_attention_bwd_q")),
             library_is="none alone: the SDPA backward, which also gives dk and dv, stands "
                        "on flash_attention_bwd_kv's entry"),
        dict(entry("conv3x3_same", "vitron_tpu_torch/csrc/conv3x3.cu",
                   "vitron_tpu/kernels/conv2d.py:99", "conv3x3",
                   sum(paths("conv3x3_same").values()), paths("conv3x3_same")),
             library_is="cuDNN F.conv2d on the bf16-rounded x and w (channels-last, bf16 in, "
                        "float32 sums); no main path calls conv3x3_same, in JAX or in the "
                        "port, so it has no launches there: held at task G's 16 eligible 3x3 "
                        "shapes",
             ms_is="sum over phase 5c's 32 rows (task G's 16 eligible 3x3 shapes x float32 "
                   "and bf16); library_ms is cuDNN's bf16 conv on both rows of a shape"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
