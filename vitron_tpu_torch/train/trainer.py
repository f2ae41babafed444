"""LoRA / QLoRA fine-tuning trainer in PyTorch.

Port of `vitron_tpu/train/trainer.py` (the reference training stack,
reference: vitron/train/train.py:1029-1264 + llava_trainer.py):

- the trainable tensors live in their own tree ({lora, projector, region}):
  gradients and optimizer state exist only for them; the frozen base (the
  LLM, int4 or dense, and the towers) never requires grad;
- per-group learning rates replicate mm_projector_lr
  (llava_trainer.py:184-271);
- step checkpoints (`torch.save` in place of Orbax) with save_total_limit
  rotation; the final save splits the LoRA factors (an HF-peft export) from
  `non_lora_trainables` (projector/region) in the same .npz files the JAX
  trainer writes (train.py:1251-1264), so either runtime loads the other's.

`_build_batch` puts the samples' `region_boxes` (their "bbox", one box an
`<objs>` slot) into the batch with the image block of each slot, as the
chat path does, so a bbox sample trains the region extractor. The JAX
trainer drops them, and its loss on such a sample is NaN (ROADMAP C9);
batches without a bbox are the same on both sides.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import random
import shutil
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from vitron_tpu_torch.constants import IGNORE_INDEX
from vitron_tpu_torch.kernels.quantization import promote_int4
from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.train import data as data_mod
from vitron_tpu_torch.train import lora as lora_mod
from vitron_tpu_torch.train import train_step as ts
from vitron_tpu_torch.train.train_step import (Optimizer, forward_loss, leaves, named_leaves,
                                               warmup_cosine_decay_schedule)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-4           # finetune_lora.sh:27
    projector_lr: Optional[float] = None  # mm_projector_lr group
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    batch_size: int = 16                  # finetune_lora.sh:29
    num_epochs: int = 1
    save_steps: int = 500                 # finetune_lora.sh:35
    save_total_limit: int = 1
    warmup_ratio: float = 0.03            # finetune_lora.sh:40
    optimizer: str = "adamw"              # "adamw" | "adafactor" (i2vgen uses
                                          # Adafactor, utils/optim/adafactor.py)
    seed: int = 0
    pad_len: int = 2048
    tune_projector: bool = True
    tune_region: bool = True
    lora: lora_mod.LoraConfig = dataclasses.field(default_factory=lora_mod.LoraConfig)


def make_optimizer(train_cfg: TrainConfig, total_steps: int,
                   trainable: Dict[str, Any]) -> Optimizer:
    """clip_by_global_norm, then AdamW (or Adafactor) with a warmup-cosine
    schedule, over `trainable`'s tensors; the projector gets its own group
    (and its own clip) when projector_lr is set (llava_trainer.py:184-271)."""
    if train_cfg.optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"optimizer {train_cfg.optimizer!r}: 'adamw' or 'adafactor'")
    warmup = max(int(train_cfg.warmup_ratio * total_steps), 1)

    def make(lr):
        sched = warmup_cosine_decay_schedule(0.0, lr, warmup, max(total_steps, warmup + 1))
        inner = (ts.adafactor(sched) if train_cfg.optimizer == "adafactor"
                 else ts.adamw(sched, weight_decay=train_cfg.weight_decay))
        return ts.chain(ts.clip_by_global_norm(train_cfg.grad_clip), inner)

    if train_cfg.projector_lr is None:
        return Optimizer([(leaves(trainable), make(train_cfg.learning_rate))])
    named = list(named_leaves(trainable))
    return Optimizer([([t for p, t in named if "projector" not in p],
                       make(train_cfg.learning_rate)),
                      ([t for p, t in named if "projector" in p], make(train_cfg.projector_lr))])


def make_lora_loss(cfg: vitron_model.VitronConfig, train_cfg: TrainConfig):
    """-> loss_fn(trainable, base, batch) -> the loss of the base with the
    LoRA factors merged and the trainable projector/region in place."""

    def loss_fn(trainable, base, batch):
        params = {**base, "llm": lora_mod.merge(base["llm"], trainable["lora"], train_cfg.lora)}
        for key in ("projector", "region"):
            if key in trainable:
                params[key] = trainable[key]
        return forward_loss(params, cfg, batch)

    return loss_fn


def make_lora_train_step(cfg: vitron_model.VitronConfig, train_cfg: TrainConfig,
                         optimizer: Optimizer):
    """-> step(trainable, base, batch) -> loss. The optimizer turns the
    gradients into the updates in place and drops them."""
    loss_fn = make_lora_loss(cfg, train_cfg)

    def step(trainable, base, batch):
        optimizer.zero_grad()
        # a8=False whatever VITRON_W4A8 says: the W4A8 serving path quantizes
        # activations, which would perturb the gradients (the packed base
        # stays B1's, as it is)
        base = promote_int4(base, a8=False)
        loss = loss_fn(trainable, base, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _trainable_copy(tree: Any) -> Any:
    return ts.map_leaves(lambda _, t: t.detach().clone().requires_grad_(True), tree)


class Trainer:
    def __init__(self, model_cfg: vitron_model.VitronConfig, train_cfg: TrainConfig,
                 base_params: Dict[str, Any], out_dir: str,
                 gen: Optional[torch.Generator] = None,
                 trainable: Optional[Dict[str, Any]] = None):
        """`gen` draws the LoRA factors (default: a generator on the LLM's
        device seeded with train_cfg.seed); `trainable` starts from given
        factors/projector/region instead (the same tree `self.trainable`
        holds)."""
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.base_params = base_params
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.device = base_params["llm"]["embed"].device
        if trainable is None:
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
            trainable = {"lora": lora_mod.init_lora_params(gen, base_params["llm"],
                                                           train_cfg.lora)}
            if train_cfg.tune_projector:
                trainable["projector"] = base_params["projector"]
            if train_cfg.tune_region:
                trainable["region"] = base_params["region"]
        self.trainable: Dict[str, Any] = _trainable_copy(trainable)
        self.step_count = 0
        self.optimizer: Optional[Optimizer] = None
        self._ckpts: List[pathlib.Path] = []

    def fit(self, dataset: data_mod.SupervisedDataset, media_loader=None,
            total_steps: Optional[int] = None, log_every: int = 10,
            image_len: Optional[int] = None,
            callback: Optional[Callable[[int, float], None]] = None) -> List[float]:
        """Train for `total_steps` (default: the epochs' batches) -> the loss
        of every step. `callback(step, loss)` runs after each step."""
        cfg, tc = self.model_cfg, self.train_cfg
        lengths = dataset.lengths()
        flags = dataset.modality_flags()
        gen = random.Random(tc.seed)
        steps_per_epoch = max(len(dataset) // tc.batch_size, 1)
        total = total_steps or steps_per_epoch * tc.num_epochs

        self.optimizer = make_optimizer(tc, total, self.trainable)
        step_fn = make_lora_train_step(cfg, tc, self.optimizer)

        losses = []
        for _ in range(tc.num_epochs):
            order = data_mod.modality_grouped_indices(lengths, flags, tc.batch_size, gen)
            for bi in range(0, len(order) - tc.batch_size + 1, tc.batch_size):
                batch = self._build_batch(dataset, order[bi:bi + tc.batch_size], media_loader,
                                          image_len)
                if batch is None:
                    continue
                loss = step_fn(self.trainable, self.base_params, batch)
                self.step_count += 1
                losses.append(float(loss))
                if callback is not None:
                    callback(self.step_count, losses[-1])
                if self.step_count % log_every == 0:
                    print(f"step {self.step_count}/{total} loss "
                          f"{np.mean(losses[-log_every:]):.4f}")
                if self.step_count % tc.save_steps == 0:
                    self.save_checkpoint()
                if self.step_count >= total:
                    self.save_final()
                    return losses
        self.save_final()
        return losses

    def _build_batch(self, dataset, idxs, media_loader, image_len):
        from vitron_tpu_torch.runtime.engine import MediaItem, prepare_batch

        rows, labels, media, boxes = [], [], [], []
        for i in idxs:
            s = dataset[i]
            rows.append(s.input_ids)
            labels.append(s.labels)
            if s.region_boxes is not None:
                boxes.append(np.asarray(s.region_boxes, np.float32).reshape(-1, 4))
            for kind, path in zip(s.media_kinds, s.media_paths):
                if media_loader is None:
                    return None
                media.append(MediaItem(kind, torch.as_tensor(media_loader(kind, path))))
        plan, images, videos, perm = prepare_batch(
            rows, media, image_len=image_len or self.model_cfg.image_tower.num_patches,
            pad_to=self.train_cfg.pad_len, labels=labels)
        if int((plan.labels != IGNORE_INDEX).sum()) == 0:
            print("WARNING: batch has zero live labels — pad_len is likely too small for the "
                  "spliced sequence (media rows count toward the budget); loss will be 0")
        dev = self.device
        batch = {
            "token_ids": torch.as_tensor(plan.token_ids, dtype=torch.long, device=dev),
            "media_idx": torch.as_tensor(plan.media_idx, dtype=torch.long, device=dev),
            "use_media": torch.as_tensor(plan.use_media, device=dev),
            "positions": torch.as_tensor(plan.position_ids, dtype=torch.long, device=dev),
            "attn_mask": torch.as_tensor(plan.attention_mask, device=dev),
            "labels": torch.as_tensor(plan.labels, dtype=torch.long, device=dev),
        }
        if images is not None:
            batch["images"] = images.to(dev)
        if videos is not None:
            batch["videos"] = videos.to(dev)
        if perm is not None:
            batch["block_perm"] = torch.as_tensor(perm, dtype=torch.long, device=dev)
        n_boxes = sum(len(b) for b in boxes)
        if n_boxes != len(plan.region_blocks):
            raise ValueError(f"batch {list(idxs)}: {len(plan.region_blocks)} <objs> slots but "
                             f"{n_boxes} region boxes")
        if n_boxes:  # in batch order, as plan_splice numbers the <objs> slots
            batch["region_boxes"] = torch.as_tensor(np.concatenate(boxes), device=dev)
            batch["region_block_idx"] = torch.as_tensor(plan.region_blocks, dtype=torch.long,
                                                        device=dev)
        return batch

    # ------------------------------------------------------------- ckpt

    def save_checkpoint(self) -> pathlib.Path:
        """A step checkpoint (trainable tensors, step, optimizer state) with
        save_total_limit rotation (finetune_lora.sh:35-37)."""
        path = self.out_dir / f"checkpoint-{self.step_count}"
        path.mkdir(parents=True, exist_ok=True)
        ckpt = {"trainable": self.trainable, "step": self.step_count}
        if self.optimizer is not None:
            ckpt["opt_state"] = self.optimizer.state_dict()
        torch.save(ckpt, path / "checkpoint.pt")
        self._ckpts.append(path)
        while len(self._ckpts) > self.train_cfg.save_total_limit:
            shutil.rmtree(self._ckpts.pop(0), ignore_errors=True)
        return path

    def resume(self, path: str):
        """Load a step checkpoint -> its optimizer state (or None)."""
        ckpt = torch.load(pathlib.Path(path) / "checkpoint.pt", map_location=self.device,
                          weights_only=True)
        self.trainable = _trainable_copy(ckpt["trainable"])
        self.step_count = int(ckpt["step"])
        return ckpt.get("opt_state")

    def save_final(self) -> None:
        """The reference's artifact split (train.py:1251-1264): adapter_model
        (LoRA, peft naming) + non_lora_trainables (projector/region, keys
        "projector.<path>"; bfloat16 tensors are written as float32, which
        numpy can hold)."""
        np.savez(self.out_dir / "adapter_model.npz",
                 **lora_mod.export_hf_lora(self.trainable["lora"], self.train_cfg.lora))
        (self.out_dir / "adapter_config.json").write_text(json.dumps({
            "r": self.train_cfg.lora.r, "lora_alpha": self.train_cfg.lora.alpha,
            "target_modules": list(self.train_cfg.lora.targets),
        }))
        non_lora = {}
        for key in ("projector", "region"):
            if key in self.trainable:
                for path, t in named_leaves(self.trainable[key]):
                    t = t.detach().cpu()
                    if t.dtype == torch.bfloat16:
                        t = t.to(torch.float32)
                    non_lora[".".join((key,) + path)] = t.numpy()
        np.savez(self.out_dir / "non_lora_trainables.npz", **non_lora)
