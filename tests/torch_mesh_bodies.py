"""Rank bodies of the port's multi-rank tests (run by tests/torch_dist.py).

Each function runs on every rank of a gloo group of CPU processes, imports
torch and the port only (no JAX), takes numpy inputs and returns numpy
arrays, numbers and lists, which the test files hold against the JAX
package computed in the test process.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from vitron_tpu_torch.core import mesh as cm
from vitron_tpu_torch.models.convert import from_jax


def mesh_checks(params_np, shape):
    """create_mesh over the world, and the Vitron tree's Shards: local
    shapes, the gather back to the full tree, embedding lookups, the int4
    leaves' splits. -> facts for the test to hold."""
    from vitron_tpu_torch.models import vitron_model

    mesh = cm.create_mesh(shape)
    params = from_jax(params_np, "cpu")
    sharded = cm.shard_params(params, mesh, vitron_model.VITRON_SHARDING_RULES)
    back = cm.gather_params(sharded)
    exact = all(torch.equal(a, b) for (_, a), (_, b) in
                zip(cm.tree_paths(params), cm.tree_paths(back)))
    local = {"/".join(p): (tuple(leaf.local.shape), leaf.spec)
             for p, leaf in cm.tree_paths(sharded)}
    embed = sharded["llm"]["embed"]
    ids = torch.tensor([[0, 5, embed.shape[0] - 1, 17]])
    lookup = bool(torch.equal(embed[ids], params["llm"]["embed"][ids]))
    groups = {ax: (dist.get_world_size(mesh.group(ax)), mesh.index(ax)) for ax in mesh.shape}
    return {"shape": mesh.shape, "size": mesh.size, "groups": groups, "exact": exact,
            "local": local, "lookup": lookup,
            "local_mesh": cm.local_mesh(dist.get_world_size()).shape}


def ring_checks(q, k, v, causal_cases, llama_params_np, llama_kw, llama_ids):
    """Ring attention over the `context` axis: the output of each causal
    case, then the tiny llama's ring prefill logits and its dense logits."""
    from vitron_tpu_torch.distributed.ring_attention import ring_attention
    from vitron_tpu_torch.models.llm import llama

    mesh = cm.create_mesh({"context": -1})
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    outs = [ring_attention(qt, kt, vt, mesh, causal=c).numpy() for c in causal_cases]
    cfg = llama.LlamaConfig.tiny(**llama_kw)
    params = from_jax(llama_params_np, "cpu")
    ids = torch.from_numpy(llama_ids).long()
    pos = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
    ring, _ = llama.forward_tokens(params, dataclasses.replace(cfg, attn_impl="ring"), ids,
                                   positions=pos, mesh=mesh)
    dense, _ = llama.forward_tokens(params, cfg, ids, positions=pos)
    return outs, ring.numpy(), dense.numpy()


def serving_checks(params_np, qparams_np, plan, px, prompts, weights_dir):
    """The tiny system on the serving mesh: greedy tokens of one planned
    image turn (float32 and int4) before and after install_mesh; then, with
    the int4 tree, two co-batched greedy chats and a sampled one through the
    batcher (rank 0 serves, the others follow), before and after; the
    memory plan's per-device rows and the KV caches' heads; and the chat
    system `build_system_from_weights` loads onto the mesh
    (`weights_checks`)."""
    from vitron_tpu_torch.apps.cli import DEMO_HOST_BUDGET, DemoTokenizer
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.generation import SamplingConfig
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
    from vitron_tpu_torch.runtime.pipeline import ServingPipeline
    from vitron_tpu_torch.runtime.sharded_serving import install_mesh, serving_mesh
    from vitron_tpu_torch.runtime.system import VitronSystem

    cfg = vitron_model.VitronConfig.tiny()
    greedy = SamplingConfig(greedy=True, max_new_tokens=10, eos_ids=())
    mesh = serving_mesh()
    out = {}

    def system(p):
        return VitronSystem(VitronEngine(from_jax(p, "cpu"), cfg, DemoTokenizer()),
                            memory_plan=MemoryPlan(budget_bytes=DEMO_HOST_BUDGET))

    def turn(s):
        return s.engine.generator.generate(plan, images=torch.from_numpy(px),
                                           sampling=greedy, decode_chunk=4)[0]

    def batch(s):
        pipe = ServingPipeline(s, batched=True, max_active=4, decode_chunk=4, num_kv_blocks=64)
        if dist.get_rank() != 0:
            pipe.batcher.follow()
            pipe.close()
            return None
        try:
            sampled = SamplingConfig(temperature=0.7, top_p=0.9, max_new_tokens=8, eos_ids=())
            futs = [pipe.submit(p, sampling=greedy) for p in prompts]
            futs.append(pipe.submit(prompts[0], image=(px[0] * 255).clip(0, 255).astype(
                np.uint8), sampling=sampled, gen=torch.Generator().manual_seed(3)))
            res = [f.result(timeout=300)["reply"]["tokens"] for f in futs]
            return res, pipe.batcher.stats()["mean_batch_occupancy"]
        finally:
            pipe.close()

    from vitron_tpu_torch.models.llm import llama
    from vitron_tpu_torch.runtime.sharded_serving import resolve_serving_mesh

    out["resolve"] = (resolve_serving_mesh(mesh) is mesh, resolve_serving_mesh(None),
                      resolve_serving_mesh("auto").shape)
    # KV heads that do not divide over `tensor`: the attention runs whole
    lcfg = llama.LlamaConfig.tiny(hidden_size=96, num_heads=6, num_kv_heads=3)
    lp = llama.init_params(torch.Generator().manual_seed(4), lcfg, "cpu")
    ids = torch.arange(1, 17)[None]
    pos = torch.arange(16)[None]
    dense, _ = llama.forward_tokens(lp, lcfg, ids, positions=pos)
    lps = cm.shard_params(lp, mesh, llama.LLAMA_SHARDING_RULES)
    got, _ = llama.forward_tokens(lps, lcfg, ids, positions=pos)
    out["kv_fallback"] = (llama.local_kv_heads(lps, lcfg), float((got - dense).abs().max()))
    out["weights"] = weights_checks(weights_dir, mesh)
    for name, p in (("f32", params_np), ("int4", qparams_np)):
        s = system(p)
        out[name + "_plain"] = turn(s)
        if name == "int4":
            out["batch_plain"] = batch(s) if dist.get_rank() == 0 else None
        install_mesh(s, mesh)
        out[name + "_mesh"] = turn(s)
        gen = s.engine.generator
        out[name + "_kv_heads"] = (gen.kv_heads(), gen.last_chunk.cache.k.shape[3])
        if name == "int4":
            out["batch_mesh"] = batch(s)
            out["plan"] = (s.memory_plan.chips, s.memory_plan.per_chip_bytes("llm+towers"),
                           s.memory_plan.entries["llm+towers"], s.memory_plan.report())
    return out


def weights_checks(weights_dir, mesh):
    """`build_system_from_weights(mesh=...)` on a chat-only weights dir
    against the same load without a mesh: the report's mesh row, one greedy
    image turn's tokens, and max |logits difference| of its prefill."""
    from vitron_tpu_torch.apps.cli import DemoTokenizer
    from vitron_tpu_torch.runtime import assembly
    from vitron_tpu_torch.runtime.generation import SamplingConfig
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan

    img = np.random.RandomState(0).randint(0, 255, (40, 40, 3), np.uint8)
    greedy = SamplingConfig(greedy=True, max_new_tokens=6, eos_ids=())
    got = []
    for m in (None, mesh):
        system, report = assembly.build_system_from_weights(
            weights_dir, geometry="tiny", device="cpu", mesh=m, tokenizer=DemoTokenizer(),
            memory_plan=MemoryPlan(budget_bytes=8 << 30))
        tokens = system.chat("describe this image", image=img, sampling=greedy)["reply"]["tokens"]
        got.append((report.rows.get("mesh"), tokens,
                    system.engine.generator.last_prefill_logits.clone()))
    (_, plain, lp), (row, sharded, ls) = got
    return row, plain, sharded, float((ls - lp).abs().max())


def video_checks(cases, cfg_parallel):
    """Tiny video UNet steps through shard_video_step over
    create_video_mesh: cases of (variant, params as numpy, args: x, t, y,
    and for i2vgen fps, image, local_image) -> (mesh shape, eps) each."""
    from vitron_tpu_torch.distributed import video_sharding as vs
    from vitron_tpu_torch.models.diffusion import unet_sd_video

    mesh = vs.create_video_mesh(cfg_parallel=cfg_parallel)
    outs = []
    for variant, params_np, args in cases:
        cfg = unet_sd_video.UNetSDVideoConfig.tiny(variant)

        def step(p, x, t, y, *i2v, cfg=cfg):
            return unet_sd_video.forward(p, cfg, x, t, y, *i2v)

        out = vs.shard_video_step(step, mesh)(from_jax(params_np, "cpu"),
                                              *(torch.from_numpy(a) for a in args))
        outs.append((mesh.shape, out.numpy()))
    return outs


def dryrun_legs():
    """`apps/dryrun_multichip.run_legs` with one 7B-width layer -> (the lines
    rank 0 printed, the train loss, the ring error, the chats' tokens, the
    video error)."""
    import contextlib
    import io

    from vitron_tpu_torch.apps import dryrun_multichip as dm

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = dm.run_legs(torch.device("cpu"), layers=1)
    return (printed.getvalue().splitlines(), out["train"], out["ring"],
            out["routed sharded serving"], out["video unet sharded step"])

