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
   UNet sites and the VAE's full resolution, float32 and bf16; also run
   twice for identical bits).
5. the chat slice at full width: VitronSystem.chat on Vicuna-7B with random
   packed-int4 projections and lm_head + bf16 ViT-L/14 tower, projector and
   region extractor; a 336x448 image, a bbox, 128 greedy tokens, twice;
   kernel launch counts, request / prefill / decode times, peak memory.
6. the chat path on the CPU and the card: a 2-layer full-width float32
   model, one prefill of the same request on both, last-position logits
   compared.
7. task A at full width: a fixed protocol reply routed by
   `VitronSystem.route` to the port's `handle_a`: SD v1.4 GLIGEN UNet, SD
   VAE, CLIP-L text, float32, 512^2, 30 grounding slots, 50 PLMS steps,
   guidance 7.5, alpha (0.3, 0, 0.7); twice (identical, non-constant
   images); launch counts of all three kernels against the block plan;
   request time, ms per CFG UNet call, VAE decode ms, peak memory.
8. task C at full width: the 9-channel inpainting UNet through handle_c's
   region branch, TASK_C_STEPS PLMS steps (fewer than A's 50, to save
   time), guidance 30; launch counts.
9. the bf16 CFG UNet step at bench.py's `bench_sd_unet` shape (SD v1.4, no
   grounding, bf16 params, [2, 64, 64, 4] latents, [2, 77, 768] context):
   `sd_unet_cfg_steps_per_s`.
10. the diffusion path on the CPU and the card: one full-width float32
   grounded CFG UNet call at reduced depth and latent size (one level,
   32x32 latents: four transformer blocks whose self-attention and fuser
   sites take the flash kernel on the card), compared with the CPU.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

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


def tree_map(fn, tree):
    """fn applied to every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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
        tflops = 4 * b * heads * s_len * s_len * d / (ms * 1e-3) / 1e12
        print(f"flash_attention gligen [{b},{s_len},{heads},{d}] bf16 non-causal shift 0: "
              f"abs_err={err:.3e} kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) plain "
              f"{plain_ms:.4f} ms [{card}]", flush=True)
        check(err <= FLASH_TOL, f"flash_attention D={d} S={s_len} abs err {err} > {FLASH_TOL}")
        rows["flash_gligen"].append((err, rel, ms, plain_ms))
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
            print(f"geglu_ff M={m} C={c} F={f} {name}: rel_err={rel:.3e} abs_err={err:.3e} "
                  f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s) plain {plain_ms:.4f} ms [{card}]",
                  flush=True)
            check(rel <= GEGLU_TOL[name], f"geglu_ff M={m} C={c} {name} rel err {rel}")
            rows["geglu"].append((err, rel, ms, plain_ms))

    for shape in ((2, 4096, 320), (2, 1024, 640), (1, 262144, 128)):
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        for dtype in (torch.float32, bf16):
            x = x32.to(dtype)
            got = gn.group_norm_sums(x)
            again = gn.group_norm_sums(x)
            want = gn.group_norm_sums_plain(x)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = cuda_ms(torch, lambda: gn.group_norm_sums(x))
            plain_ms = cuda_ms(torch, lambda: gn.group_norm_sums_plain(x))
            gbs = x.numel() * x.element_size() / (ms * 1e-3) / 1e9
            name = str(dtype).split(".")[-1]
            print(f"group_norm_sums {list(shape)} {name}: rel_err={rel:.3e} kernel {ms:.4f} ms "
                  f"({gbs:.0f} GB/s) plain {plain_ms:.4f} ms, same bits twice="
                  f"{bool(torch.equal(got, again))} [{card}]", flush=True)
            check(rel <= GN_TOL, f"group_norm_sums {shape} {name} rel err {rel} > {GN_TOL}")
            check(bool(torch.equal(got, again)), f"group_norm_sums {shape} not deterministic")
            rows["gn"].append((err, rel, ms, plain_ms))
    return rows


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


def vae_counts(vcfg, latent: int):
    """(encode, decode) kernel launches: group norm twice per ResNet, once in
    the mid attention, once at the output; flash in the mid attention, which
    runs at the latent size."""
    from vitron_tpu_torch.models.diffusion.layers import _flash_min

    levels = len(vcfg.channel_mult)
    flash = int(latent * latent >= _flash_min())
    enc = {"flash_attention": flash, "geglu_ff": 0,
           "group_norm_sums": 2 * (levels * vcfg.num_res_blocks + 2) + 2}
    dec = {"flash_attention": flash, "geglu_ff": 0,
           "group_norm_sums": 2 * (levels * (vcfg.num_res_blocks + 1) + 2) + 2}
    return enc, dec


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


def timed_route(torch, system, reply, image=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.route(reply, image=image)
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
    _, dec = vae_counts(cfg.vae, cfg.latent_size)
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
    enc, dec = vae_counts(cfg.vae, cfg.latent_size)
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
        chat = phase_slice(torch, card)
        phase_cpu_vs_card(torch, card)
        from vitron_tpu_torch.models.diffusion.gligen_pipeline import GligenConfig
        from vitron_tpu_torch.models.diffusion.unet2d import UNetConfig

        dev = torch.device("cuda")
        t0 = time.perf_counter()
        pipe = build_gligen(torch, GligenConfig(), dev, seed=0)
        torch.cuda.synchronize()
        print(f"gligen: SD v1.4 GLIGEN UNet (4 and 9 channels), SD VAE, CLIP-L text, float32 "
              f"random weights built on the card in {time.perf_counter() - t0:.1f} s", flush=True)
        task_a = phase_task_a(torch, card, pipe)
        task_c = phase_task_c(torch, card, pipe)
        del pipe
        torch.cuda.empty_cache()
        phase_sd_unet_bf16(torch, card, UNetConfig.sd_v1(), dev)
        phase_unet_cpu_vs_card(torch, card, UNetConfig.sd_v1(
            channel_mult=(1,), num_res_blocks=1, attention_resolutions=(1,)), dev)

    def entry(name, source, replaces, key, launches, paths):
        r = rows[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": paths,
                "max_abs_err": max(x[0] for x in r),
                "max_rel_err": max(x[1] for x in r), "ms": sum(x[2] for x in r),
                "plain_ms": sum(x[3] for x in r),
                "ms_is": f"sum over the {len(r)} main-path shapes above"}

    def paths(name):
        return {"chat": chat.get(name, 0), "task_a": task_a.get(name, 0),
                "task_c": task_c.get(name, 0)}

    rows["flash"] += rows.pop("flash_gligen")
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
