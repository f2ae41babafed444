"""The port's LoRA/QLoRA trainer against the JAX package on the CPU.

The data helpers, the LoRA merge and export, prepare_batch with a fixed pad
length and labels, the int4 gradient, the warmup-cosine schedule, the
global-norm clip and the AdamW updates are held against JAX and optax; one
LoRA step at `VitronConfig.tiny()` over an int4 base (port
`attn_impl="flash"`, JAX `"xla"`: Pallas cannot run uninterpreted on the
CPU) gives the same loss (1e-4 relative) and gradients (1e-4 of each
gradient's max); three `Trainer.fit` steps from the same factors give the
same losses and artifacts; remat gives the same gradients. Both trainers
start from JAX's state, carried across by `models.convert`.
"""
import json
import random

import numpy as np
import pytest
import torch

from vitron_tpu_torch.apps.cli import DemoTokenizer
from vitron_tpu_torch.models import vitron_model as tvm
from vitron_tpu_torch.models.convert import from_jax, to_numpy
from vitron_tpu_torch.models.llm.llama import LlamaConfig
from vitron_tpu_torch.train import data as tdata
from vitron_tpu_torch.train import lora as tlora
from vitron_tpu_torch.train import train_step as tstep
from vitron_tpu_torch.train import trainer as ttrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 1e-4   # float32 on both sides; attention by two routes (flash / einsum)
GRAD_TOL = 1e-4    # max |port - JAX| / max |JAX| per gradient
LORA = dict(r=4, alpha=8)
IMAGE_LEN = 16     # ViTConfig.tiny: 28 / 7 = 4 x 4 patches


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _items(n=4):
    return [{"conversations": [
        {"from": "human", "value": "<image>\nwhat color is this thing in the picture?"},
        {"from": "gpt", "value": f"it is color number {i} and it is bright"},
        {"from": "human", "value": "and the shape?"},
        {"from": "gpt", "value": "round " * (i + 1)}],
        "image": f"img_{i}.png"} for i in range(n)]


def _media_loader(kind, path):
    seed = int(path.rsplit("_", 1)[1].split(".")[0])
    return np.random.RandomState(seed).rand(28, 28, 3).astype(np.float32)


def _configs():
    from vitron_tpu.models import vitron_model as jvm

    return jvm.VitronConfig.tiny(), tvm.VitronConfig.tiny(llm=LlamaConfig.tiny(attn_impl="flash"))


def _int4_base(jcfg):
    import jax

    from vitron_tpu.kernels.quantization import quantize_llama
    from vitron_tpu.models import vitron_model as jvm

    base = dict(jvm.init_params(jax.random.PRNGKey(0), jcfg))
    base["llm"] = quantize_llama(base["llm"], bits=4)
    return base


def _float32_lora(trainable):
    """JAX draws bfloat16 factors over a quantized base; the tests carry them
    in float32, so that gradients and updates are not rounded to bf16's
    2^-9 (which alone would part the two sides by one bf16 step)."""
    import jax
    import jax.numpy as jnp

    return {**trainable, "lora": jax.tree.map(lambda a: a.astype(jnp.float32),
                                              trainable["lora"])}


def _trainable(jbase, lcfg):
    """JAX's initial factors with B made nonzero (so that dA is not zero),
    the projector and the region extractor."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.train import lora as jlora

    lp = jlora.init_lora_params(jax.random.PRNGKey(1), jbase["llm"], lcfg)
    rs = np.random.RandomState(3)
    lp = {k: {"a": ab["a"], "b": jnp.asarray(0.05 * rs.randn(*ab["b"].shape), ab["b"].dtype)}
          for k, ab in lp.items()}
    return _float32_lora({"lora": lp, "projector": jbase["projector"],
                          "region": jbase["region"]})


# ------------------------------------------------------------- host helpers

def test_data_helpers_match_jax(tmp_path):
    from vitron_tpu.train import data as jdata

    tok = DemoTokenizer()
    src = [[{"from": "human", "value": "<video>\nwhat happens?"},
            {"from": "gpt", "value": "a dog runs"}]]
    assert tdata.preprocess_multimodal(src, 4) == jdata.preprocess_multimodal(src, 4)
    for has_image in (False, True):
        s = tdata.preprocess_multimodal([_items(1)[0]["conversations"]], 8)
        assert (tdata.preprocess_v1(s, tok, has_image=has_image, model_max_length=40)
                == jdata.preprocess_v1(s, tok, has_image=has_image, model_max_length=40))
    items = _items(6) + [{"conversations": [{"from": "human", "value": "hi there"},
                                            {"from": "gpt", "value": "hello"}]}]
    path = tmp_path / "d.json"
    path.write_text(json.dumps(items))
    tds, jds = tdata.SupervisedDataset(str(path), tok), jdata.SupervisedDataset(str(path), tok)
    assert tds.lengths() == jds.lengths() and tds.modality_flags() == jds.modality_flags()
    for i in range(len(items)):
        a, b = tds[i], jds[i]
        assert (a.input_ids, a.labels, a.media_kinds, a.media_paths, a.length) == (
            b.input_ids, b.labels, b.media_kinds, b.media_paths, b.length)
    lengths, flags = list(range(40)), [i % 3 != 0 for i in range(40)]
    assert (tdata.modality_grouped_indices(lengths, flags, 4, random.Random(5))
            == jdata.modality_grouped_indices(lengths, flags, 4, random.Random(5)))


def test_prepare_batch_pad_to_and_labels_match_jax():
    import dataclasses

    from vitron_tpu.runtime import engine as jengine

    from vitron_tpu_torch.runtime import engine as tengine

    rows = [[1, 5, -200, 6, 7, 8], [1, -200, 9]]
    labels = [[-100, -100, -200, 6, 7, 8], [-100, -200, 9]]
    pix = np.random.RandomState(0).rand(28, 28, 3).astype(np.float32)
    got = tengine.prepare_batch(rows, [tengine.MediaItem("image", torch.from_numpy(pix))] * 2,
                                image_len=IMAGE_LEN, pad_to=40, labels=labels)[0]
    want = jengine.prepare_batch(rows, [jengine.MediaItem("image", pix)] * 2, pad_to=40,
                                 labels=labels, image_len=IMAGE_LEN)[0]
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)
    assert got.token_ids.shape == (2, 40)


def test_lora_merge_and_export_match_jax():
    import jax

    from vitron_tpu.kernels.quantization import quantize_llama
    from vitron_tpu.models.llm import llama as jllama
    from vitron_tpu.train import lora as jlora

    lcfg_j, lcfg_t = jlora.LoraConfig(**LORA), tlora.LoraConfig(**LORA)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig.tiny())
    jlp = jax.tree.map(lambda x: x + 0.01, jlora.init_lora_params(jax.random.PRNGKey(1),
                                                                  jparams, lcfg_j))
    tlp = from_jax(_np_tree(jlp), "cpu")
    for base in (jparams, quantize_llama(jparams, bits=4)):
        want = _np_tree(jlora.merge(base, jlp, lcfg_j)["layers"])
        got = to_numpy(tlora.merge(from_jax(_np_tree(base), "cpu"), tlp, lcfg_t)["layers"])
        for name in tlora.LORA_TARGETS:
            if isinstance(want[name], dict):
                assert sorted(got[name]) == sorted(want[name])
                for key in want[name]:
                    np.testing.assert_allclose(got[name][key], want[name][key], rtol=1e-6)
            else:
                np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6)
    want = jlora.export_hf_lora(jlp, lcfg_j)
    got = tlora.export_hf_lora(tlp, lcfg_t)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    # the port's own draw: A ~ N(0, 1/in) in bfloat16 over an int4 base, B = 0
    q4 = from_jax(_np_tree(quantize_llama(jparams, bits=4)), "cpu")
    mine = tlora.init_lora_params(torch.Generator().manual_seed(0), q4, lcfg_t)
    a, b = mine["wq"]["a"], mine["wq"]["b"]
    assert a.dtype == torch.bfloat16 and a.shape == (2, 64, 4) and not b.any()
    assert 0.05 < float(a.float().std()) < 0.2  # 1 / sqrt(64) = 0.125


def test_int4_gradient_matches_jax():
    """The port's Int4Matmul backward against the JAX custom_vjp of the
    Pallas int4 matmul (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.int4_matmul import int4_matmul as jax_int4
    from vitron_tpu.kernels.quantization import quantize_int4

    from vitron_tpu_torch.kernels import int4_matmul as ti4

    rs = np.random.RandomState(0)
    x, w, g = rs.randn(5, 64), rs.randn(64, 24) * 0.1, rs.randn(5, 24)
    qw = quantize_int4(jnp.asarray(w, jnp.float32))
    want = jax.grad(lambda x_: jnp.sum(jax_int4(x_, qw["q4"], qw["s"], interpret=True)
                                       * jnp.asarray(g, jnp.float32)))(
        jnp.asarray(x, jnp.float32))
    tx = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    y = ti4.int4_matmul(tx, torch.tensor(np.asarray(qw["q4"])),
                        torch.tensor(np.asarray(qw["s"])))
    assert y.grad_fn is not None and "Int4Matmul" in type(y.grad_fn).__name__
    y.backward(torch.tensor(g, dtype=torch.float32))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_schedule_clip_and_adamw_match_optax():
    import optax

    for warmup, total, peak in ((1, 4, 2e-4), (3, 100, 1e-3), (5, 6, 0.5)):
        want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
        got = tstep.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
        for c in range(0, total + 3):  # optax evaluates in float32
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-5, atol=1e-6 * peak)

    rs = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "projector": {"w": (4, 2)}}
    params = {"a": rs.randn(3, 4), "b": rs.randn(5), "projector": {"w": rs.randn(4, 2)}}
    for scale in (0.01, 10.0):  # global norm below and above the clip
        grads = [{k: (scale * rs.randn(*s) if not isinstance(s, dict) else
                      {"w": scale * rs.randn(*s["w"])}) for k, s in shapes.items()}
                 for _ in range(3)]
        clip = optax.clip_by_global_norm(1.0)
        want_c, _ = clip.update(_jnp_tree(grads[0]), clip.init(None))
        got_c = _torch_tree(grads[0])
        tstep.clip_by_global_norm_(tstep.leaves(got_c), 1.0)
        _close(got_c, want_c, 1e-6)

        tc = ttrainer.TrainConfig(learning_rate=1e-2, projector_lr=3e-2, weight_decay=0.1,
                                  warmup_ratio=0.3)
        want_p = _jnp_tree(params)
        opt = _jax_make_optimizer(tc, 4)
        state = opt.init(want_p)
        got_p = _torch_tree(params, grad=True)
        topt = ttrainer.make_optimizer(tc, 4, got_p)
        for g in grads:
            upd, state = opt.update(_jnp_tree(g), state, want_p)
            want_p = optax.apply_updates(want_p, upd)
            for (_, p), (_, gg) in zip(tstep.named_leaves(got_p),
                                       tstep.named_leaves(_torch_tree(g))):
                p.grad = gg
            topt.step()
        _close(got_p, want_p, 1e-6)


def _jax_make_optimizer(tc, total):
    from vitron_tpu.train import trainer as jtrainer

    return jtrainer.make_optimizer(jtrainer.TrainConfig(
        learning_rate=tc.learning_rate, projector_lr=tc.projector_lr,
        weight_decay=tc.weight_decay, warmup_ratio=tc.warmup_ratio), total)


def _jnp_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=torch.float32, requires_grad=grad)


def _close(got, want, tol):
    got, want = to_numpy(got), _np_tree(want)
    flat_g = dict(tstep.named_leaves(got))
    for path, w in tstep.named_leaves(want):
        np.testing.assert_allclose(flat_g[path], w, rtol=tol, atol=tol, err_msg=str(path))


def test_adafactor_is_not_ported():
    """Adafactor, once the trainer's gap, is ported: TrainConfig(optimizer=
    "adafactor") gives JAX's chain (clip_by_global_norm, then
    optax.adafactor at the warmup-cosine schedule) over factored, unfactored
    and 1-D tensors, with the projector's own group, held against JAX's
    make_optimizer over three steps."""
    import optax

    rs = np.random.RandomState(3)
    shapes = {"a": (160, 130), "b": (7,), "c": (3, 200, 150), "projector": {"w": (130, 4)}}

    def tree(f):
        return {k: (f(s) if not isinstance(s, dict) else {"w": f(s["w"])})
                for k, s in shapes.items()}

    params = tree(lambda s: rs.randn(*s))
    tc = ttrainer.TrainConfig(learning_rate=1e-2, projector_lr=3e-2, warmup_ratio=0.3,
                              optimizer="adafactor")
    from vitron_tpu.train import trainer as jtrainer

    opt = jtrainer.make_optimizer(jtrainer.TrainConfig(
        learning_rate=tc.learning_rate, projector_lr=tc.projector_lr,
        warmup_ratio=tc.warmup_ratio, optimizer="adafactor"), 6)
    want_p = _jnp_tree(params)
    state = opt.init(want_p)
    got_p = _torch_tree(params, grad=True)
    topt = ttrainer.make_optimizer(tc, 6, got_p)
    for i in range(3):
        g = tree(lambda s: (0.01 if i else 10.0) * rs.randn(*s))
        upd, state = opt.update(_jnp_tree(g), state, want_p)
        want_p = optax.apply_updates(want_p, upd)
        for (_, p), (_, gg) in zip(tstep.named_leaves(got_p), tstep.named_leaves(_torch_tree(g))):
            p.grad = gg
        topt.step()
        _close(got_p, want_p, 1e-5)


# ------------------------------------------------------------- the slice

def _batches(tmp_path, jcfg, tcfg, jbase, tbase, trainable):
    """One batch of 2 rows from the same dataset for both trainers."""
    from vitron_tpu.train import data as jdata
    from vitron_tpu.train import lora as jlora
    from vitron_tpu.train.trainer import TrainConfig as JTrainConfig
    from vitron_tpu.train.trainer import Trainer as JTrainer

    path = tmp_path / "d.json"
    path.write_text(json.dumps(_items()))
    tok = DemoTokenizer()
    jtr = JTrainer(jcfg, JTrainConfig(batch_size=2, pad_len=128, lora=jlora.LoraConfig(**LORA)),
                   jbase, str(tmp_path / "j"))
    ttr = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(batch_size=2, pad_len=128,
                                                      lora=tlora.LoraConfig(**LORA)),
                           tbase, str(tmp_path / "t"), trainable=trainable)
    jb = jtr._build_batch(jdata.SupervisedDataset(str(path), tok), [0, 3], _media_loader,
                          IMAGE_LEN)
    tb = ttr._build_batch(tdata.SupervisedDataset(str(path), tok), [0, 3], _media_loader,
                          IMAGE_LEN)
    return jb, tb, ttr


@pytest.mark.parametrize("remat", [False, True])
def test_lora_step_matches_jax(tmp_path, remat):
    """Loss and every trainable gradient of one LoRA step over an int4 base;
    the region extractor's gradient is zero on both sides (the samples carry
    no bbox). With remat the port recomputes each layer in the backward and
    gives the same gradients."""
    import jax

    from vitron_tpu.kernels.quantization import promote_int4
    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.train import lora as jlora
    from vitron_tpu.train.losses import causal_lm_loss

    jcfg, tcfg = _configs()
    if remat:
        tcfg = tvm.VitronConfig.tiny(llm=LlamaConfig.tiny(attn_impl="flash", remat=True))
    jbase = _int4_base(jcfg)
    lcfg = jlora.LoraConfig(**LORA)
    jtrain = _trainable(jbase, lcfg)
    tbase = from_jax(_np_tree(jbase), "cpu")
    jb, tb, ttr = _batches(tmp_path, jcfg, tcfg, jbase, tbase, from_jax(_np_tree(jtrain), "cpu"))
    assert int((tb["labels"] != -100).sum()) > 10  # the labels survive the splice

    def jloss(trainable, base):
        base = promote_int4(base, a8=False)
        params = {**base, "llm": jlora.merge(base["llm"], trainable["lora"], lcfg),
                  "projector": trainable["projector"], "region": trainable["region"]}
        logits, _ = jvm.forward(params, jcfg, jb["token_ids"], jb["media_idx"],
                                jb["use_media"], jb["positions"], jb["attn_mask"],
                                images=jb.get("images"))
        return causal_lm_loss(logits, jb["labels"])

    want_loss, want_g = jax.value_and_grad(jloss)(jtrain, jbase)
    loss = ttrainer.make_lora_loss(tcfg, ttr.train_cfg)(ttr.trainable, tbase, tb)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    got_g = {path: t.grad for path, t in tstep.named_leaves(ttr.trainable)}
    for path, w in tstep.named_leaves(_np_tree(want_g)):
        if path[0] == "region":
            assert not np.any(w) and got_g[path] is None, path
            continue
        g = got_g[path].float().numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert np.abs(w).max() > 0 and err <= GRAD_TOL, (path, err)


def test_train_step_matches_jax(tmp_path):
    """make_train_step over the whole (dense, float32) parameter tree with
    lora.trainable_filter: the towers and the LLM frozen (zero gradients,
    so AdamW leaves them as they are), the projector and region trainable;
    two steps against the JAX train step with optax's AdamW."""
    import jax

    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.train import lora as jlora
    from vitron_tpu.train import train_step as jstep

    jcfg, tcfg = _configs()
    jparams = jvm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(_np_tree(jparams), "cpu")
    for t in tstep.leaves(tparams):
        t.requires_grad_(True)
    jb, tb, _ = _batches(tmp_path, jcfg, tcfg, jparams, tparams, None)
    jopt = jstep.make_optimizer(lr=1e-3)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, jlora.trainable_filter()))
    topt = tstep.make_optimizer(tstep.leaves(tparams), lr=1e-3)
    tfn = tstep.make_train_step(tcfg, topt, tlora.trainable_filter())
    state = jopt.init(jparams)
    for _ in range(2):
        jparams, state, want_loss = jfn(jparams, state, jb)
        loss = tfn(tparams, tb)
        assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want = _np_tree(jparams)
    got = dict(tstep.named_leaves(to_numpy(tparams)))
    start = dict(tstep.named_leaves(_np_tree(jvm.init_params(jax.random.PRNGKey(0), jcfg))))
    for path, w in tstep.named_leaves(want):
        if path[0] in ("projector", "region"):
            np.testing.assert_allclose(got[path], w, rtol=0, atol=5e-5, err_msg=str(path))
        else:  # frozen: not moved on either side
            np.testing.assert_array_equal(got[path], start[path], err_msg=str(path))
            np.testing.assert_array_equal(w, start[path], err_msg=str(path))
    assert not np.array_equal(got[("projector", "w1")], start[("projector", "w1")])


def _as_adamw_moves(got: dict, want: dict, lr: float, steps: int) -> None:
    """Leaves after `steps` AdamW steps at `lr` against JAX's: each element
    within 5e-5, but for at most 1 in 1,000 of a leaf and every element of
    a key bias, and those within 2 lr a step. AdamW moves an element by
    about lr whatever its gradient's size, so one whose gradient lies in the
    rounding noise (a key bias's is 0 in exact arithmetic) may move the
    other way on either side."""
    for path, w in want.items():
        diff = np.abs(got[path] - w)
        assert float(diff.max()) <= 2 * lr * steps, (path, float(diff.max()))
        if path[-1] != "bk":
            assert (diff > 5e-5).mean() <= 1e-3, (path, int((diff > 5e-5).sum()))


def test_unfiltered_step_trains_the_towers_as_jax(tmp_path):
    """make_train_step without a trainable_filter, as JAX's dryrun runs it:
    every float leaf trains, the vision towers too (`encode_media` keeps
    their graph where a tower leaf requires a gradient). Two AdamW steps at
    lr 1e-3 from JAX's initial tree: the same losses, the leaves as JAX's
    (`_as_adamw_moves`), and the towers moved by 2 lr on both sides."""
    import jax

    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.train import train_step as jstep

    jcfg, tcfg = _configs()
    jparams = jvm.init_params(jax.random.PRNGKey(0), jcfg)
    start = dict(tstep.named_leaves(_np_tree(jparams)))
    tparams = from_jax(_np_tree(jparams), "cpu")
    jb, tb, _ = _batches(tmp_path, jcfg, tcfg, jparams, tparams, None)
    jopt = jstep.make_optimizer(lr=1e-3)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt))
    trainable = tstep.set_trainable(tparams)
    assert len(trainable) == len(start)
    tfn = tstep.make_train_step(tcfg, tstep.make_optimizer(trainable, lr=1e-3))
    state = jopt.init(jparams)
    for _ in range(2):
        jparams, state, want_loss = jfn(jparams, state, jb)
        loss = tfn(tparams, tb)
        assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want = dict(tstep.named_leaves(_np_tree(jparams)))
    got = dict(tstep.named_leaves(to_numpy(tparams)))
    _as_adamw_moves(got, want, 1e-3, 2)
    for path in (("image_tower", "patch_proj"), ("image_tower", "layers", "attn", "wq"),
                 ("image_tower", "layers", "fc1")):
        for tree in (got, want):
            assert abs(float(np.abs(tree[path] - start[path]).max()) - 2e-3) <= 1e-5, path


def test_filtered_step_keeps_the_towers_out_of_the_backward(tmp_path):
    """set_trainable with lora.trainable_filter: only the projector and the
    region extractor require gradients, the towers run under no_grad (no
    tower leaf gets a .grad) and stay as they were, the projector moves."""
    import jax

    from vitron_tpu.models import vitron_model as jvm

    jcfg, tcfg = _configs()
    jparams = jvm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(_np_tree(jparams), "cpu")
    _, tb, _ = _batches(tmp_path, jcfg, tcfg, jparams, tparams, None)
    trainable = tstep.set_trainable(tparams, tlora.trainable_filter())
    assert {p[0] for p, t in tstep.named_leaves(tparams) if t.requires_grad} == {"projector",
                                                                                 "region"}
    assert len(trainable) == sum(t.requires_grad for t in tstep.leaves(tparams))
    start = {p: t.detach().clone() for p, t in tstep.named_leaves(tparams)}
    tstep.make_train_step(tcfg, tstep.make_optimizer(trainable, lr=1e-3),
                          tlora.trainable_filter())(tparams, tb)
    for path, t in tstep.named_leaves(tparams):
        if path[0] in ("image_tower", "video_tower"):
            assert t.grad is None and torch.equal(t, start[path]), path
    assert not torch.equal(tparams["projector"]["w1"], start[("projector", "w1")])


def test_fit_matches_jax(tmp_path):
    """Three Trainer.fit steps from JAX's initial factors (B = 0): the losses
    and the saved artifacts. The first step runs at the warmup's learning
    rate 0, so the factors move at steps 2 and 3."""
    import jax

    from vitron_tpu.train import data as jdata
    from vitron_tpu.train import lora as jlora
    from vitron_tpu.train.trainer import TrainConfig as JTrainConfig
    from vitron_tpu.train.trainer import Trainer as JTrainer

    jcfg, tcfg = _configs()
    jbase = _int4_base(jcfg)
    path = tmp_path / "d.json"
    path.write_text(json.dumps(_items(6)))
    kw = dict(batch_size=2, pad_len=128, save_steps=100, learning_rate=1e-3)
    jtr = JTrainer(jcfg, JTrainConfig(lora=jlora.LoraConfig(**LORA), **kw), jbase,
                   str(tmp_path / "j"), rng=jax.random.PRNGKey(1))
    jtr.trainable = _float32_lora(jtr.trainable)
    ttr = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(lora=tlora.LoraConfig(**LORA), **kw),
                           from_jax(_np_tree(jbase), "cpu"), str(tmp_path / "t"),
                           trainable=from_jax(_np_tree(jtr.trainable), "cpu"))
    tok = DemoTokenizer()
    want = jtr.fit(jdata.SupervisedDataset(str(path), tok), _media_loader, total_steps=3,
                   image_len=IMAGE_LEN)
    got = ttr.fit(tdata.SupervisedDataset(str(path), tok), _media_loader, total_steps=3,
                  image_len=IMAGE_LEN)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert len(got) == 3 and got[0] > 0.5
    assert (json.loads((tmp_path / "t" / "adapter_config.json").read_text())
            == json.loads((tmp_path / "j" / "adapter_config.json").read_text()))
    moved = 0
    for name in ("adapter_model.npz", "non_lora_trainables.npz"):
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            # Adam divides by sqrt(v), so a gradient entry near 0 moves its
            # factor by a share of the learning rate (1e-3) that float32 sums
            # in another order can change: measured 1.2e-5 at most
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=5e-5, err_msg=key)
            moved += int(np.abs(b[key]).max() > 0 and "lora_B" in key)
    assert moved == 2 * 7  # every B factor left zero


def test_checkpoint_rotation_and_resume(tmp_path):
    cfg = tvm.VitronConfig.tiny()
    base = tvm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tr = ttrainer.Trainer(cfg, ttrainer.TrainConfig(save_total_limit=1,
                                                    lora=tlora.LoraConfig(**LORA)),
                          base, str(tmp_path))
    tr.optimizer = ttrainer.make_optimizer(tr.train_cfg, 4, tr.trainable)
    tr.step_count = 3
    first = tr.save_checkpoint()
    with torch.no_grad():
        tr.trainable["lora"]["wq"]["b"].add_(1.0)
    tr.step_count = 5
    second = tr.save_checkpoint()
    assert not first.exists() and second.exists()
    again = ttrainer.Trainer(cfg, tr.train_cfg, base, str(tmp_path))
    opt_state = again.resume(str(second))
    assert again.step_count == 5 and opt_state["count"] == 0
    for (p, a), (_, b) in zip(tstep.named_leaves(again.trainable),
                              tstep.named_leaves(tr.trainable)):
        assert torch.equal(a, b), p
        assert a.requires_grad


def test_region_boxes_are_dropped_as_in_jax(tmp_path):
    """ROADMAP C9, repaired on the port's side. The JAX trainer still drops
    a sample's region_boxes: its `<objs>` slot then gathers past the image
    features and JAX's loss comes out NaN (the reference fault, kept as it
    is). The port's `_build_batch` puts the boxes and their image blocks
    into the batch: the loss is finite, the region extractor gets a finite,
    non-zero gradient, and the spliced embeddings of each row (its region
    features among them) equal those of the inference path for the same
    image and box (`prepare_batch` without labels, boxes and
    `plan.region_blocks` as `Generator.generate` passes them)."""
    import jax

    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.train import data as jdata
    from vitron_tpu.train import lora as jlora
    from vitron_tpu.train.losses import causal_lm_loss
    from vitron_tpu.train.trainer import TrainConfig as JTrainConfig
    from vitron_tpu.train.trainer import Trainer as JTrainer
    from vitron_tpu_torch.runtime.engine import MediaItem, prepare_batch

    items = [{"conversations": [{"from": "human", "value": "<image>\nwhat is in <objs> here?"},
                                {"from": "gpt", "value": "a red car parked"}],
              "image": f"img_{i}.png", "bbox": [[2 + i, 3, 20, 25 - i]]} for i in range(2)]
    path = tmp_path / "d.json"
    path.write_text(json.dumps(items))
    jcfg, tcfg = _configs()
    jbase = jvm.init_params(jax.random.PRNGKey(0), jcfg)
    jtr = JTrainer(jcfg, JTrainConfig(batch_size=2, pad_len=128, lora=jlora.LoraConfig(**LORA)),
                   jbase, str(tmp_path / "j"))
    tbase = from_jax(_np_tree(jbase), "cpu")
    ttr = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(batch_size=2, pad_len=128,
                                                      lora=tlora.LoraConfig(**LORA)),
                           tbase, str(tmp_path / "t"))
    tok = DemoTokenizer()
    jds, tds = jdata.SupervisedDataset(str(path), tok), tdata.SupervisedDataset(str(path), tok)
    assert jds[0].region_boxes is not None and tds[0].region_boxes is not None
    jb = jtr._build_batch(jds, [0, 1], _media_loader, IMAGE_LEN)
    tb = ttr._build_batch(tds, [0, 1], _media_loader, IMAGE_LEN)
    assert "region_boxes" not in jb
    params = {**jbase, "llm": jlora.merge(jbase["llm"], jtr.trainable["lora"], jtr.train_cfg.lora)}
    logits, _ = jvm.forward(params, jcfg, jb["token_ids"], jb["media_idx"], jb["use_media"],
                            jb["positions"], jb["attn_mask"], images=jb["images"])
    assert not np.isfinite(float(causal_lm_loss(logits, jb["labels"])))

    np.testing.assert_array_equal(tb["region_boxes"].numpy(), [[2, 3, 20, 25], [3, 3, 20, 24]])
    assert tb["region_block_idx"].tolist() == [0, 1]
    loss = ttrainer.make_lora_loss(tcfg, ttr.train_cfg)(ttr.trainable, tbase, tb)
    assert np.isfinite(float(loss.detach()))
    loss.backward()
    region = [t.grad for p, t in tstep.named_leaves(ttr.trainable) if p[0] == "region"]
    assert region and all(g is not None and bool(torch.isfinite(g).all()) for g in region)
    assert any(bool(g.abs().max() > 0) for g in region)

    params = {**tbase, "region": ttr.trainable["region"], "projector": ttr.trainable["projector"]}
    with torch.no_grad():
        train_embeds = tvm.spliced_embeds(
            params, tcfg, tb["token_ids"], tb["media_idx"], tb["use_media"],
            images=tb["images"], region_boxes=tb["region_boxes"],
            region_block_idx=tb["region_block_idx"])
        for i in range(2):
            sample = tds[i]
            plan, images, _, _ = prepare_batch(
                [sample.input_ids],
                [MediaItem("image", torch.as_tensor(_media_loader("image", f"img_{i}.png")))],
                image_len=IMAGE_LEN)
            infer = tvm.spliced_embeds(
                params, tcfg, torch.as_tensor(plan.token_ids, dtype=torch.long),
                torch.as_tensor(plan.media_idx, dtype=torch.long),
                torch.as_tensor(plan.use_media), images=images,
                region_boxes=torch.as_tensor(sample.region_boxes),
                region_block_idx=torch.as_tensor(plan.region_blocks, dtype=torch.long))
            n = int(plan.seq_lens[0])
            region_rows = plan.media_idx[0, :n] >= plan.n_image_blocks * IMAGE_LEN
            assert plan.use_media[0, :n][region_rows].sum() == 1  # the <objs> slot
            torch.testing.assert_close(train_embeds[i, :n], infer[0, :n], rtol=1e-5, atol=1e-5)


def test_smoke_dataset_boxes_reach_the_batch(tmp_path):
    """ROADMAP C10: `chip_smoke.train_dataset(..., boxes=1)` asks its first
    conversation about a region (an `<objs>` slot and a "bbox"), and the
    port's `_build_batch` carries that box and its image block into the
    batch, as the card's training check builds it; the other sample has
    none."""
    import chip_smoke
    from vitron_tpu_torch.models.vision.vit import ViTConfig
    from vitron_tpu_torch.models.vitron_model import VitronConfig

    path = chip_smoke.train_dataset(tmp_path / "d.json", 2, 1, words=(4, 6, 5, 8), boxes=1)
    items = json.loads(path.read_text())
    assert items[0]["bbox"] == [chip_smoke.TRAIN_BOX] and "bbox" not in items[1]
    assert "<objs>" in items[0]["conversations"][0]["value"]
    ds = tdata.SupervisedDataset(str(path), DemoTokenizer(), model_max_length=128)
    assert ds[1].region_boxes is None
    np.testing.assert_array_equal(ds[0].region_boxes, [chip_smoke.TRAIN_BOX])
    cfg = VitronConfig(llm=LlamaConfig.tiny(vocab_size=32000), image_tower=ViTConfig.tiny(),
                       video_tower=ViTConfig.tiny(add_time_attn=True))
    gen = torch.Generator().manual_seed(0)
    tr = ttrainer.Trainer(cfg, ttrainer.TrainConfig(batch_size=2, pad_len=128),
                          tvm.init_params(gen, cfg, "cpu"), str(tmp_path / "t"))
    batch = tr._build_batch(ds, [0, 1], _media_loader, IMAGE_LEN)
    np.testing.assert_array_equal(batch["region_boxes"].numpy(), [chip_smoke.TRAIN_BOX])
    assert batch["region_block_idx"].tolist() == [0]


def _bf16_grad(x, w, split=None, drop=None):
    """x @ w with bf16 inputs and float32 sums, rounded to bf16 as a bf16
    step's gradient is: summed over K in `split` parts (another order), or
    without K rows drop[0]:drop[1] (a dropped chunk)."""
    xb, wb = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    if drop is not None:
        xb = xb.clone()
        xb[:, drop[0]:drop[1]] = 0
    if split is None:
        return (xb @ wb).to(torch.bfloat16)
    parts = torch.tensor_split(torch.arange(x.shape[1]), split)
    return sum(xb[:, p] @ wb[p] for p in parts).to(torch.bfloat16)


@pytest.mark.parametrize("case,within", [
    ("reordered in two halves", True), ("reordered in seven parts", True),
    ("a dropped 64-deep chunk of K 4096", False), ("a dropped 64-deep chunk of K 11008", False),
    ("a dropped 64-column block", False)])
def test_bf16_grad_limit_passes_reordered_sums_and_fails_dropped_chunks(case, within):
    """ROADMAP C11: `chip_smoke.grads_within` under TRAIN_BF16_GRAD_LIMIT
    passes a product summed in another order (bf16 roundings flip) and
    fails one that lost a 64-deep K chunk, as a B1 tile would, or a block
    of 64 output columns."""
    import chip_smoke

    rs = np.random.RandomState(3)
    k = 11008 if "11008" in case else 4096
    x = torch.from_numpy(rs.randn(256, k).astype(np.float32))
    w = torch.from_numpy(rs.randn(k, 512).astype(np.float32) / k ** 0.5)
    want = {"g": _bf16_grad(x, w)}
    if case.startswith("reordered"):
        got = _bf16_grad(x, w, split=2 if "two" in case else 7)
        assert not torch.equal(got, want["g"])  # some roundings flipped
    elif "column" in case:
        got = want["g"].clone()
        got[:, 64:128] = 0
    else:
        got = _bf16_grad(x, w, drop=(64, 128))
    (cos, rel, ok), = chip_smoke.grads_within({"g": got}, want).values()
    assert ok == within, (cos, rel)
