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
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
from pathlib import Path

from flash_rows import HERE, load_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--layers", type=int, default=4)
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
