#!/usr/bin/env python3
"""How far one LoRA step's gradients move when B1 (the int4 matmul) sums in
another order, for one checkout of the repo.

    python3 tools/grad_noise.py [--root CHECKOUT] [--layers N]

It builds the trainer's model at full width (`VitronConfig` with
`vicuna_7b(attn_impl="flash")` cut to `--layers` layers, random packed int4
projections and lm_head as `chip_smoke.random_int4_llm` makes them, LoRA r
128 from `init_lora_params`) on the card, takes one batch of 2 x 2048 slots
(`chip_smoke.train_dataset`) and computes the loss and the LoRA gradients
three times: with B1's kernel, with its plain version (`int4_matmul_plain`:
unpack, one float32 matmul), and with the plain version summed over the two
halves of K and then added. For each of the two against the plain version
it prints each gradient's max |difference| over its max |plain|, the
cosine similarity and the share of elements whose sign flips. A gradient
that moves as much under the halves as under the kernel is dominated by
the rounding of float32 sums, and an optimizer that normalizes each element
(AdamW) turns that noise into different steps. Needs one CUDA device.

    python3 tools/grad_noise.py --check [--root CHECKOUT]

measures instead what the smoke's bf16 training check (ROADMAP C11,
`chip_smoke.phase_train_cpu_vs_card`) holds: the same 2-layer state with a
bf16 LLM and one bbox sample, one LoRA step on the CPU with the plain
versions (the reference) and on the card with B1's and B5's kernels, with
B1's plain version on the card (the same function summed in another
order), and with two faults put in on purpose: every B1 call without its
second 64-deep K chunk, and B5a and B5b without the second 64-key tile of
every row. For each it prints every gradient's cosine with the
reference's and ||card - cpu|| / ||cpu||, and whether
`chip_smoke.grads_within` holds it under TRAIN_BF16_GRAD_LIMIT: the two
right versions must pass and the two faults fail.

    python3 tools/grad_noise.py --gligen [--root CHECKOUT]

does the same for the GLIGEN trainer's check
(`chip_smoke.phase_train_cpu_vs_card_diffusion`, the state of
`gligen_cpu_vs_card_setup`): one step on the CPU with float32 einsum
attention (the reference) and on the card with bf16 flash (B2, B5a, B5b at
D 40), with B5's plain version on the card, and with B5a and B5b without
the second 64-key tile of every row; each trainable gradient held by
`chip_smoke.grads_within` under GLIGEN_BF16_GRAD_LIMIT: the two right
versions must pass and the fault fail.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
from pathlib import Path

from flash_rows import HERE, load_smoke


def check_limits(torch, smoke) -> int:
    """The bf16 training check's noise and two faults against its limit."""
    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.kernels import flash_attention as fa
    from vitron_tpu_torch.kernels import int4_matmul as i4
    from vitron_tpu_torch.train.data import SupervisedDataset

    card = smoke.nvidia_smi_line()
    cfg, params, trainable, tc = smoke.train_cpu_vs_card_setup(torch)
    cfg, params = smoke.bf16_llm(torch, cfg, params)
    kernel, bwd = i4._int4_matmul, fa.flash_attention_bwd

    def no_chunk(x, q4, s):  # B1 without K rows 64..127
        x = x.clone()
        x[:, 64:128] = 0
        return kernel(x, q4, s)

    def no_tile(q, k, v, kv_mask, *rest):  # B5 without keys 64..127
        mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device) if kv_mask is None \
            else kv_mask.clone()
        mask[:, 64:128] = False
        return bwd(q, k, v, mask, *rest)

    variants = (("kernels", kernel, bwd, True), ("B1 plain on the card", i4.int4_matmul_plain,
                                                 bwd, True),
                ("B1 dropped K chunk", no_chunk, bwd, False),
                ("B5 dropped key tile", kernel, no_tile, False))
    failures = 0
    with tempfile.TemporaryDirectory() as tmp:
        ds = SupervisedDataset(str(smoke.train_dataset(pathlib.Path(tmp) / "d.json", 2, 1,
                                                       words=(40, 60, 100, 140), boxes=1)),
                               DemoTokenizer(), model_max_length=512)
        loss, want, _, sec = smoke.lora_step(torch, cfg, tc, params, trainable, ds,
                                             torch.device("cpu"), tmp)
        print(f"check: CPU bf16 plain step loss {loss:.6f} in {sec:.1f} s [{card}]", flush=True)
        for name, b1, b5, right in variants:
            i4._int4_matmul, fa.flash_attention_bwd = b1, b5
            try:
                loss, got, _, sec = smoke.lora_step(torch, cfg, tc, params, trainable, ds,
                                                    torch.device("cuda"), tmp)
            finally:
                i4._int4_matmul, fa.flash_attention_bwd = kernel, bwd
            held = smoke.grads_within(got, want)
            ok = all(v[2] for v in held.values())
            print(f"check: {name}: loss {loss:.6f}, lowest cosine "
                  f"{min(v[0] for v in held.values()):.6f}, largest relative norm "
                  f"{max(v[1] for v in held.values()):.3e}, within "
                  f"{smoke.TRAIN_BF16_GRAD_LIMIT}: {ok} (should be {right}) [{card}]", flush=True)
            for key in sorted(held):
                print(f"  {name} {key}: cosine {held[key][0]:.6f}, relative norm "
                      f"{held[key][1]:.3e}", flush=True)
            failures += ok != right
            torch.cuda.empty_cache()
    return int(failures > 0)


def check_gligen_limits(torch, smoke) -> int:
    """The GLIGEN training check's noise and a fault against its limit."""
    from vitron_tpu_torch.kernels import flash_attention as fa

    card = smoke.nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False  # as the smoke runs: float32 convs in float32
    torch.backends.cudnn.allow_tf32 = False
    setup = smoke.gligen_cpu_vs_card_setup(torch)
    bwd = fa.flash_attention_bwd

    def no_tile(q, k, v, kv_mask, *rest):  # B5 without keys 64..127
        mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device) if kv_mask is None \
            else kv_mask.clone()
        mask[:, 64:128] = False
        return bwd(q, k, v, mask, *rest)

    variants = (("kernels", bwd, True),
                ("B5 plain on the card", fa.flash_attention_bwd_plain, True),
                ("B5 dropped key tile", no_tile, False))
    loss, want, _, _ = smoke.gligen_step_on(torch, setup, torch.device("cpu"))
    print(f"gligen check: CPU float32 einsum step loss {loss:.6f} [{card}]", flush=True)
    failures = 0
    for name, b5, right in variants:
        fa.flash_attention_bwd = b5
        try:
            loss, got, _, _ = smoke.gligen_step_on(torch, setup, torch.device("cuda"))
        finally:
            fa.flash_attention_bwd = bwd
        held = smoke.grads_within(got, want, smoke.GLIGEN_BF16_GRAD_LIMIT)
        ok = all(v[2] for v in held.values())
        print(f"gligen check: {name}: loss {loss:.6f}, lowest cosine "
              f"{min(v[0] for v in held.values()):.6f}, largest relative norm "
              f"{max(v[1] for v in held.values()):.3e}, within "
              f"{smoke.GLIGEN_BF16_GRAD_LIMIT}: {ok} (should be {right}) [{card}]", flush=True)
        for key in sorted(held, key=lambda k: held[k][0])[:6]:
            print(f"  {name} {'.'.join(map(str, key))}: cosine {held[key][0]:.6f}, relative "
                  f"norm {held[key][1]:.3e}", flush=True)
        failures += ok != right
        torch.cuda.empty_cache()
    return int(failures > 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--check", action="store_true",
                    help="the bf16 training check's noise and faults against its limit")
    ap.add_argument("--gligen", action="store_true",
                    help="the GLIGEN training check's noise and a fault against its limit")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.kernels import int4_matmul as i4
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig
    from vitron_tpu_torch.train.data import SupervisedDataset
    from vitron_tpu_torch.train.lora import init_lora_params
    from vitron_tpu_torch.train.train_step import named_leaves
    from vitron_tpu_torch.train.trainer import Trainer, TrainConfig, make_lora_loss

    if not torch.cuda.is_available():
        print("grad_noise: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    if args.check:
        return check_limits(torch, smoke)
    if args.gligen:
        return check_gligen_limits(torch, smoke)
    card = smoke.nvidia_smi_line()
    dev = torch.device("cuda")
    cfg = VitronConfig(
        llm=LlamaConfig.vicuna_7b(num_layers=args.layers, attn_impl="flash",
                                  max_seq_len=smoke.TRAIN_SEQ),
        image_tower=ViTConfig.clip_vit_l14(), video_tower=ViTConfig.video_vit_l14())
    gen = torch.Generator(device=dev).manual_seed(3)
    params = smoke.random_int4_llm(torch, vitron_model.init_params(gen, cfg, dev), gen, dev)
    del params["video_tower"]
    tc = TrainConfig(batch_size=smoke.TRAIN_BATCH, pad_len=smoke.TRAIN_SEQ, save_steps=10 ** 9)
    trainable = {"lora": init_lora_params(gen, params["llm"], tc.lora),
                 "projector": params["projector"], "region": params["region"]}

    def halves(x, q4, s):
        k = q4.shape[0] // 2 * 2  # K rows in the first half
        w = i4.unpack_int4(q4).float()
        xf = x.float()
        return ((xf[:, :k] @ w[:k] + xf[:, k:] @ w[k:]) * s).to(x.dtype)

    kernel = i4._int4_matmul
    losses, grads = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        data = smoke.train_dataset(pathlib.Path(tmp) / "d.json", 2, 1, words=smoke.TRAIN_WORDS)
        ds = SupervisedDataset(str(data), DemoTokenizer(), model_max_length=smoke.TRAIN_SEQ)
        for name, fn in (("kernel", kernel), ("plain", i4.int4_matmul_plain), ("halves", halves)):
            i4._int4_matmul = fn
            tr = Trainer(cfg, tc, params, tmp,
                         trainable=smoke.tree_map(lambda a: a.detach().clone(), trainable))
            batch = tr._build_batch(ds, [0, 1], smoke.train_media_loader(
                200, cfg.image_tower.image_size), None)
            with torch.enable_grad():
                loss = make_lora_loss(cfg, tc)(tr.trainable, params, batch)
                loss.backward()
            losses[name] = float(loss.detach())
            grads[name] = {".".join(p): t.grad.float().clone()
                           for p, t in named_leaves(tr.trainable)
                           if t.grad is not None and t.grad.abs().max() > 0}
            del tr, batch, loss
            torch.cuda.empty_cache()
    i4._int4_matmul = kernel
    print(f"losses: " + ", ".join(f"{k} {v:.6f}" for k, v in losses.items()) + f" [{card}]")
    for side in ("kernel", "halves"):
        for key, want in sorted(grads["plain"].items()):
            got = grads[side][key]
            rel = ((got - want).abs().max() / want.abs().max()).item()
            cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
            flips = ((got.sign() != want.sign()) & (want != 0)).float().mean().item()
            print(f"{side} vs plain {key}: max rel {rel:.3e}, cosine {cos.item():.6f}, sign "
                  f"flips {flips:.3e} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
