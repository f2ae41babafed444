"""Multi-device dry run: the legs of the JAX package's
`__graft_entry__.dryrun_multichip`, on the port's process groups.

    torchrun --nproc-per-node 4 -m vitron_tpu_torch.apps.dryrun_multichip
    python -m vitron_tpu_torch.apps.dryrun_multichip --spawn 4 --device cpu

Under torchrun each rank joins the group from the environment (NCCL, one
card a rank); `--spawn N` starts N processes itself (gloo with `--device
cpu`, NCCL on N cards otherwise) on a store at 127.0.0.1. Legs, in order:

- train: JAX's first leg. The tiny Vitron (JAX's `_tiny_cfg`) on a (data,
  fsdp, tensor) mesh by JAX's factorisation (tensor 2 when N is even, data
  2 when 4 divides N, fsdp the rest), placed by `VITRON_SHARDING_RULES`,
  one unfiltered AdamW step (lr 1e-4, the global-norm clip) of
  `make_train_step` on JAX's two-row example batch split on `data`;
- ring: the tiny llama's prefill with attn_impl="ring" over an n-way
  `context` axis against the dense logits;
- 7b sharded decode: Vicuna-7B widths (4 layers), fsdp x tensor placement
  with each rank filling only its own blocks (a hash of the global index,
  JAX's `_fill_like`), two paged decode steps with the pool's KV heads on
  `tensor`, and the per-device plan of the full 32-layer deployment;
- routed sharded serving: the tiny Vitron system on the serving mesh, two
  co-batched chats through the batcher (rank 0 serves, the others follow),
  then a routed task-D step on a replicated backend;
- video sharded step: the tiny t2v UNet step over `create_video_mesh`
  against the unsharded step.

Rank 0 prints one line a leg; the run fails if a leg does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

GIB = 1024 ** 3
# the tiny configs at head dims the card's kernels take (B2: 64, B7: 32)
TINY_LLAMA = dict(hidden_size=256, num_heads=4, num_kv_heads=4)
TINY_VIDEO = dict(head_dim=32)
# the train leg's LLM (JAX's `__graft_entry__._tiny_cfg`): einsum
# attention, so no kernel constrains its head dim
TINY_VITRON_LLM = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=4, max_seq_len=256,
                       param_dtype=torch.float32, compute_dtype=torch.float32)
TINY_VITRON_TOWER = dict(hidden_size=64, num_heads=4)


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def tiny_vitron():
    """JAX's `__graft_entry__._tiny_cfg`."""
    from vitron_tpu_torch.models.llm.llama import LlamaConfig
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig

    return VitronConfig(llm=LlamaConfig(**TINY_VITRON_LLM),
                        image_tower=ViTConfig.tiny(**TINY_VITRON_TOWER),
                        video_tower=ViTConfig.tiny(**TINY_VITRON_TOWER, add_time_attn=True))


def example_batch(cfg, device, pad_len: int = 128):
    """JAX's `__graft_entry__._example_batch` at batch 2: a row with an image
    and a region, a row with four image slots; every text token a label; the
    image and the video from RandomState 0 and 1; one region box."""
    from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX, OBJS_TOKEN_INDEX
    from vitron_tpu_torch.runtime.engine import MediaItem, prepare_batch

    rows = [[1, 5, IMAGE_TOKEN_INDEX, 6, OBJS_TOKEN_INDEX, 7],
            [1, 8, IMAGE_TOKEN_INDEX, IMAGE_TOKEN_INDEX, IMAGE_TOKEN_INDEX, IMAGE_TOKEN_INDEX, 9]]
    s, nf = cfg.image_tower.image_size, cfg.video_tower.num_frames
    media = [MediaItem("image", torch.from_numpy(
                 np.random.RandomState(0).rand(s, s, 3).astype(np.float32))),
             MediaItem("video", torch.from_numpy(
                 np.random.RandomState(1).rand(nf, s, s, 3).astype(np.float32)))]
    plan, images, videos, perm = prepare_batch(
        rows, media, pad_to=pad_len, image_len=cfg.image_tower.num_patches,
        labels=[[t if t >= 0 else -100 for t in row] for row in rows])

    def ints(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)

    return {"token_ids": ints(plan.token_ids), "media_idx": ints(plan.media_idx),
            "use_media": torch.as_tensor(plan.use_media, device=device),
            "positions": ints(plan.position_ids),
            "attn_mask": torch.as_tensor(plan.attention_mask, device=device),
            "labels": ints(plan.labels), "images": images.to(device),
            "videos": videos.to(device), "block_perm": ints(perm),
            "region_boxes": torch.tensor([[2.0, 2.0, 20.0, 24.0]], device=device),
            "region_block_idx": ints(plan.region_blocks)}


def train_mesh_shape(n: int) -> dict:
    """JAX's dryrun factorisation of n ranks into (data, fsdp, tensor)."""
    tensor = 2 if n % 2 == 0 else 1
    data = 2 if n % 4 == 0 else 1
    return {"data": data, "fsdp": n // (tensor * data), "tensor": tensor}


def leg_train(device) -> float:
    """One unfiltered sharded train step of the tiny Vitron -> its loss."""
    from vitron_tpu_torch.core.mesh import create_mesh, shard_params
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.train import train_step as ts

    shape = train_mesh_shape(dist.get_world_size())
    mesh = create_mesh(shape)
    cfg = tiny_vitron()
    params = vitron_model.init_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    params = shard_params(params, mesh, vitron_model.VITRON_SHARDING_RULES)
    step = ts.make_train_step(cfg, ts.make_optimizer(ts.set_trainable(params), lr=1e-4))
    loss = float(step(params, example_batch(cfg, device)))
    if not np.isfinite(loss):
        raise AssertionError(f"train step sharded: non-finite loss {loss}")
    _say(f"train step sharded: mesh=({shape['data']},{shape['fsdp']},{shape['tensor']}) "
         f"loss={loss:.4f} OK")
    return loss


def leg_ring(device) -> float:
    """The llama prefill over the ring against the dense logits -> max |err|."""
    from vitron_tpu_torch.core.mesh import create_mesh
    from vitron_tpu_torch.models.llm import llama

    n = dist.get_world_size()
    mesh = create_mesh({"context": n})
    cfg = llama.LlamaConfig.tiny(**TINY_LLAMA)
    params = llama.init_params(torch.Generator(device=device).manual_seed(1), cfg, device)
    s = 8 * n
    ids = (torch.arange(s, device=device)[None] % cfg.vocab_size)
    pos = torch.arange(s, device=device)[None]
    dense, _ = llama.forward_tokens(params, cfg, ids, positions=pos)
    ring, _ = llama.forward_tokens(params, dataclasses.replace(cfg, attn_impl="ring"), ids,
                                   positions=pos, mesh=mesh)
    err = float((ring - dense).abs().max())
    if not err < 1e-3:
        raise AssertionError(f"ring attention diverges from dense: {err}")
    _say(f"ring: context={n} prefill[{s}] err={err:.2e} OK")
    return err


def _fill(shape, spec, mesh, dtype, device) -> torch.Tensor:
    """This rank's block of a deterministic fill of the full `shape`:
    ((global index * 2654435761 mod 2^32) >> 8) % 4096 / 4096 - 0.5, x 0.05."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        size = shape[d] // (mesh.shape[spec[d]] if spec[d] else 1)
        start = mesh.index(spec[d]) * size if spec[d] else 0
        ar = torch.arange(start, start + size, dtype=torch.int64, device=device) * stride
        idx = idx + ar.reshape((size,) + (1,) * (len(shape) - 1 - d))
        stride *= shape[d]
    h = ((idx * 2654435761) & 0xFFFFFFFF) >> 8
    return (((h % 4096).to(torch.float32) / 4096.0 - 0.5) * 0.05).to(dtype)


def _abstract_llm(cfg):
    """(path, shape) of every leaf of the llama tree, without tensors."""
    h, f, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    kvd = cfg.num_kv_heads * cfg.head_dim
    layers = {"attn_norm": (l, h), "wq": (l, h, h), "wk": (l, h, kvd), "wv": (l, h, kvd),
              "wo": (l, h, h), "mlp_norm": (l, h), "gate": (l, h, f), "up": (l, h, f),
              "down": (l, f, h)}
    return ([(("embed",), (cfg.vocab_size, h))]
            + [(("layers", k), s) for k, s in layers.items()]
            + [(("final_norm",), (h,)), (("lm_head",), (h, cfg.vocab_size))])


def leg_7b_sharded_decode(device, layers: int = 4):
    """Vicuna-7B widths over fsdp x tensor: two paged decode steps -> the plan."""
    from vitron_tpu_torch.core.mesh import Shard, create_mesh, fit_spec, spec_for
    from vitron_tpu_torch.models.llm import llama, paged_cache
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan, kv_cache_bytes
    from vitron_tpu_torch.runtime.sharded_serving import paged_pool_shardings

    n = dist.get_world_size()
    tensor = 2 if n % 2 == 0 else 1
    mesh = create_mesh({"fsdp": n // tensor, "tensor": tensor})
    full = llama.LlamaConfig.vicuna_7b()
    cfg = dataclasses.replace(full, num_layers=layers)
    params = {"layers": {}}
    for path, shape in _abstract_llm(cfg):
        spec = fit_spec(spec_for(path, llama.LLAMA_SHARDING_RULES), shape, mesh)
        leaf = Shard(_fill(shape, spec, mesh, cfg.param_dtype, device), spec, shape, mesh)
        (params["layers"] if path[0] == "layers" else params)[path[-1]] = leaf
    kv = llama.local_kv_heads(params, cfg)
    pool = paged_cache.PagedPool.create(cfg, num_blocks=8, block_size=16, device=device,
                                        kv_heads=kv)
    seq = paged_cache.PagedSequence(blocks=[])
    table = torch.zeros((1, pool.k.shape[1]), dtype=torch.int64, device=device)
    tok = torch.zeros((1,), dtype=torch.int64, device=device)
    for _ in range(2):
        seq.ensure_capacity(pool, 1)
        table[0, :len(seq.blocks)] = torch.as_tensor(seq.blocks, device=device)
        pos = torch.tensor([[seq.length]], device=device)
        logits, k_new, v_new = paged_cache.paged_decode_step(
            params, cfg, params["embed"][tok[:, None]], pos, pool, table,
            torch.tensor([seq.length + 1], device=device))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("7b sharded decode: non-finite logits")
        paged_cache.write_tokens(pool, seq, k_new, v_new)
        tok = torch.argmax(logits, dim=-1)

    def nbytes(shapes):
        return sum(int(np.prod(s)) for _, s in shapes) * 2  # bf16

    llm_bytes = nbytes(_abstract_llm(full))
    pool_bytes = kv_cache_bytes(full.num_layers, 1, 8 * 16, full.num_kv_heads, full.head_dim)
    plan = MemoryPlan(budget_bytes=80 * GIB, chips=n)
    plan.add("llm-7b (bf16, fsdp+tp)", llm_bytes, sharded=True)
    plan.add("paged-kv-pool (tp)", pool_bytes,
             shard_factor=tensor if paged_pool_shardings(mesh, full) else 1)
    plan.add("vision towers (est)", int(1.2 * GIB))
    plan.add("seem (est)", int(0.9 * GIB))
    plan.add("sd/gligen (est)", int(2.5 * GIB))
    plan.add("video unet (int8, est)", int(4.42 * GIB))
    _say(plan.report())
    if not plan.fits:
        raise AssertionError("7B multi-device plan exceeds the per-device budget")
    _say(f"7b sharded decode: mesh=(fsdp={n // tensor},tensor={tensor}) 2 paged decode steps "
         f"at 7B width / {layers} layers, KV heads {kv}/rank OK (llm {llm_bytes / GIB:.2f} "
         f"GiB total, {plan.per_chip_bytes('llm-7b (bf16, fsdp+tp)') / GIB:.2f} GiB/device)")
    return plan


def leg_routed_serving(device):
    """Two co-batched chats on the serving mesh, then a routed task-D step."""
    from vitron_tpu_torch.apps.cli import build_demo_system
    from vitron_tpu_torch.models.diffusion import clip_text, unet_sd_video, vae
    from vitron_tpu_torch.models.diffusion import video_pipelines as vp
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
    from vitron_tpu_torch.runtime.generation import SamplingConfig
    from vitron_tpu_torch.runtime.pipeline import ServingPipeline
    from vitron_tpu_torch.runtime.router import route_model_output
    from vitron_tpu_torch.runtime.sharded_serving import install_mesh, serving_mesh

    system = build_demo_system(device, 0)
    mesh = serving_mesh()
    install_mesh(system, mesh)
    tcfg = vp.Text2VideoConfig.tiny(
        steps=1, unet=unet_sd_video.UNetSDVideoConfig.tiny("t2v", context_dim=16, y_dim=16,
                                                           **TINY_VIDEO))
    g = torch.Generator(device=device).manual_seed(1)
    system.register_text2video(vp.Text2VideoPipeline(
        tcfg, fill_zero_leaves(unet_sd_video.init_params(g, tcfg.unet, device), g),
        vae.init_params(g, tcfg.vae, device), clip_text.init_params(g, tcfg.text, device),
        tokenizer=StubClipTokenizer(tcfg.text.vocab_size)))
    pipeline = ServingPipeline(system, batched=True, max_active=4, decode_chunk=4,
                               num_kv_blocks=32)
    if dist.get_rank() != 0:
        pipeline.batcher.follow()
        pipeline.close()
        return None
    try:
        sampling = SamplingConfig(greedy=True, max_new_tokens=4, eos_ids=())
        futs = [pipeline.submit(f"hello {i}", sampling=sampling) for i in range(2)]
        outs = [f.result(timeout=600) for f in futs]
        if not all(isinstance(o["reply"]["raw"], str) for o in outs):
            raise AssertionError("a chat gave no reply")
        routed = route_model_output(
            system.registry, "<module>D</module> <instruction>prompt: a dog</instruction>")
        if routed["status"] != "ok" or routed["video"].shape[0] != tcfg.num_frames:
            raise AssertionError(f"task D routed badly: {routed['status']}")
        stats = pipeline.batcher.stats()
    finally:
        pipeline.close()
    _say(f"routed sharded serving: mesh={mesh.shape} 2 co-batched chats "
         f"(mean batch {stats['mean_batch_occupancy']}) + task-D step OK")
    return [o["reply"]["tokens"] for o in outs]


def leg_video_sharded_step(device) -> float:
    """The (cfg, frames)-sharded tiny t2v step against the unsharded one."""
    from vitron_tpu_torch.distributed import video_sharding as vs
    from vitron_tpu_torch.models.diffusion import unet_sd_video
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    cfg = unet_sd_video.UNetSDVideoConfig.tiny("t2v", **TINY_VIDEO)
    g = torch.Generator(device=device).manual_seed(2)
    params = fill_zero_leaves(unet_sd_video.init_params(g, cfg, device), g)
    mesh = vs.create_video_mesh()
    x = torch.randn((2, 8, 8, 8, 4), generator=g, device=device)
    t = torch.full((2,), 3.0, device=device)
    ctx = torch.randn((2, 7, 1024), generator=g, device=device) * 0.02

    def step(p, x, t, ctx):
        return unet_sd_video.forward(p, cfg, x, t, y=ctx)

    dense = step(params, x, t, ctx)
    out = vs.shard_video_step(step, mesh)(params, x, t, ctx)
    err = float((out - dense).abs().max())
    if not err < 1e-3:
        raise AssertionError(f"sharded video step diverges: {err}")
    _say(f"video unet sharded step: mesh={mesh.shape} err={err:.2e} OK")
    return err


def run_legs(device, layers: int = 4) -> dict:
    """Every leg, in JAX's order -> each leg's result by name."""
    t0 = time.monotonic()
    out = {}
    for name, fn in (("train", leg_train), ("ring", leg_ring),
                     ("7b sharded decode", lambda d: leg_7b_sharded_decode(d, layers)),
                     ("routed sharded serving", leg_routed_serving),
                     ("video unet sharded step", leg_video_sharded_step)):
        with torch.set_grad_enabled(fn is leg_train):
            out[name] = fn(device)
        _say(f"# {name}: {time.monotonic() - t0:.1f} s")
    _say(f"dryrun_multichip({dist.get_world_size()}): OK")
    return out


def _rank_main(rank: int, n: int, port: int, backend: str, layers: int) -> None:
    from vitron_tpu_torch.core import distributed as vdist

    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1 if backend == "gloo" else torch.get_num_threads())
    vdist.initialize(vdist.DistributedConfig(coordinator_address=f"127.0.0.1:{port}",
                                             num_processes=n, process_id=rank),
                     backend=backend)
    try:
        run_legs(vdist.device(), layers)
    finally:
        vdist.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="multi-device dry run: a sharded train step, "
                                "then the serving legs")
    p.add_argument("--spawn", type=int, default=0,
                   help="start this many ranks here (without it: the torchrun env)")
    p.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    p.add_argument("--layers", type=int, default=4, help="layers of the 7B-width decode leg")
    args = p.parse_args(argv)
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2
    if args.spawn:
        import torch.multiprocessing as mp

        if backend == "nccl" and torch.cuda.device_count() < args.spawn:
            print(f"error: {args.spawn} ranks need {args.spawn} cards, have "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.start_processes(_rank_main, args=(args.spawn, port, backend, args.layers),
                           nprocs=args.spawn, start_method="spawn")
        return 0
    from vitron_tpu_torch.core import distributed as vdist

    if not vdist.initialize(backend=backend):
        print("error: no process group: run under torchrun or pass --spawn N", file=sys.stderr)
        return 2
    try:
        run_legs(vdist.device(), args.layers)
    finally:
        vdist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
