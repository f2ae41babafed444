"""Parity of the port's SEEM slice (tasks B/E and C's SEEM branch) with the
JAX package on the CPU: FocalNet, the pixel decoder, the language encoder,
the decoder with every query group, the segment_* entry points and
track_video, postprocessing, the visualize helpers, and the B / E / C
handlers routed through `VitronSystem`.

`SeemConfig.tiny()`, float32. The JAX params come from the JAX
`init_params`; every all-zero leaf (biases, logit_scale) is filled by
`synthetic.fill_zero_leaves`, the layerscale gammas are drawn from
U(0.5, 1.5) (their 1e-4 init hides the blocks), and the same tree goes to
both packages with `from_jax`. Inputs are numpy arrays from a seeded
RandomState. Tolerance: max |port - jax| <= 1e-4 * max |jax| unless stated.

Each decoder layer blocks the keys where sigmoid(resized mask logit) < 0.5.
A logit within float32 noise of 0 could flip a bit between the frameworks
and move the next layer discontinuously, so the tests count flipped bits
of those attention masks separately from the activation error; with the
seeds below none flips (the smallest |logit| at a threshold is printed).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
from vitron_tpu_torch.models.seem import decoder as tdec
from vitron_tpu_torch.models.seem import focalnet as tfocal
from vitron_tpu_torch.models.seem import language as tlang
from vitron_tpu_torch.models.seem import model as tmodel
from vitron_tpu_torch.models.seem import pixel_decoder as tpix
from vitron_tpu_torch.models.seem import postprocess as tpp
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-4


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rel(got, want):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _close(got, want, rtol=RTOL):
    rel = _rel(got, want)
    assert rel <= rtol, f"max |port - jax| / max |jax| = {rel:.3e} > {rtol}"


@pytest.fixture(scope="module")
def seem():
    """(JAX cfg, port cfg, JAX params as jnp arrays, port params) of one live
    tiny SEEM."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.seem import model as jmodel

    jcfg = jmodel.SeemConfig.tiny()
    tp = fill_zero_leaves(from_jax(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), jcfg)), "cpu"), torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    for stage in tp["backbone"]["stages"]:
        for blk in stage["blocks"]:
            for key in ("gamma_1", "gamma_2"):
                blk[key] = 0.5 + torch.rand(blk[key].shape, generator=g)
    jp = _tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    return jcfg, tmodel.SeemConfig.tiny(), jp, tp


def _image(seed, shape=(64, 64, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def _phrase_ids(cfg, words, seed=3):
    """[1, ctx] ids with zero padding after the EOT (the largest id) and
    their validity mask."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((1, cfg.lang.context_length), np.int64)
    toks = [cfg.lang.vocab_size - 2] + list(rs.randint(1, cfg.lang.vocab_size - 3, words))
    toks.append(cfg.lang.vocab_size - 1)
    ids[0, :len(toks)] = toks
    return ids, (ids != 0).astype(np.int64)


class _JaxAttnMasks:
    """Records the JAX decoder's cross-attention masks: the outputs of its
    antialias-free jax.image.resize, thresholded as the decoder does."""

    def __init__(self, monkeypatch):
        import jax

        self.logits = []
        orig = jax.image.resize

        def resize(image, shape, method, antialias=True, **kw):
            out = orig(image, shape, method, antialias=antialias, **kw)
            if not antialias and not isinstance(out, jax.core.Tracer):
                self.logits.append(np.asarray(out))
            return out

        monkeypatch.setattr(jax.image, "resize", resize)

    def bits(self):
        out = []
        for lg in self.logits:
            am = 1 / (1 + np.exp(-lg.reshape(1, lg.shape[1], -1).astype(np.float64))) < 0.5
            out.append(am & ~am.all(-1, keepdims=True))
        return out


def _flipped(jax_rec, port_masks):
    """(flipped attention-mask bits, smallest |logit| of the JAX masks)."""
    jbits = jax_rec.bits()
    assert len(jbits) == len(port_masks)
    flips = sum(int((np.asarray(j) != p.numpy()).sum()) for j, p in zip(jbits, port_masks))
    margin = min(float(np.abs(lg).min()) for lg in jax_rec.logits)
    print(f"attention-mask bits flipped: {flips}; smallest |logit| {margin:.3e}")
    return flips, margin


# ------------------------------------------------------------------ modules


def test_focalnet_matches_jax(seem):
    import jax.numpy as jnp

    from vitron_tpu.models.seem import focalnet as jfocal

    jcfg, tcfg, jp, tp = seem
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    want = jfocal.forward(jp["backbone"], jcfg.backbone, jnp.asarray(x))
    got = tfocal.forward(tp["backbone"], tcfg.backbone, torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)


def test_pixel_decoder_matches_jax(seem):
    import jax.numpy as jnp

    from vitron_tpu.models.seem import pixel_decoder as jpix

    jcfg, tcfg, jp, tp = seem
    rs = np.random.RandomState(1)
    feats = [rs.randn(1, 16, 16, 16).astype(np.float32), rs.randn(1, 8, 8, 32).astype(np.float32)]
    jmask, jms = jpix.forward_features(jp["pixel"], jcfg.pixel, [jnp.asarray(f) for f in feats])
    tmask, tms = tpix.forward_features(tp["pixel"], tcfg.pixel, [torch.from_numpy(f) for f in feats])
    _close(tmask, jmask)
    for g, w in zip(tms, jms):
        _close(g, w)
    _close(tpix.position_embedding_sine(7, 9, 32), jpix.position_embedding_sine(7, 9, 32))


def test_language_matches_jax(seem):
    import jax.numpy as jnp

    from vitron_tpu.models.seem import language as jlang

    jcfg, tcfg, jp, tp = seem
    ids = np.random.RandomState(2).randint(1, 126, (3, 16))
    ids[:, 9] = 127  # the EOT, the largest id
    for norm in (False, True):
        jt, jc = jlang.token_and_class_emb(jp["lang"], jcfg.lang, jnp.asarray(ids), norm=norm)
        tt, tc = tlang.token_and_class_emb(tp["lang"], tcfg.lang, torch.from_numpy(ids), norm=norm)
        _close(tt, jt)
        _close(tc, jc)
    tok = StubClipTokenizer(tcfg.lang.vocab_size)
    names = ["car", "wall-other-merged", "door-stuff"]
    jids, n_t = jlang.class_prompt_ids(tok, names, jcfg.lang)
    tids, _ = tlang.class_prompt_ids(tok, names, tcfg.lang)
    np.testing.assert_array_equal(tids, jids)
    want = jlang.class_embeddings_from_ids(jp["lang"], jcfg.lang, jnp.asarray(jids), n_t)
    got = tlang.class_embeddings_from_ids(tp["lang"], tcfg.lang, torch.from_numpy(tids), n_t)
    _close(got, want)
    _close(tlang.class_embeddings(tp["lang"], tcfg.lang, tok, names), want)


def test_decoder_all_groups_match_jax(seem, monkeypatch):
    """One decoder forward with grounding, spatial, visual and audio groups,
    padded slots and a class bank."""
    import jax.numpy as jnp

    from vitron_tpu.models.seem import decoder as jdec

    jcfg, tcfg, jp, tp = seem
    d = tcfg.decoder.hidden_dim
    rs = np.random.RandomState(4)
    ms = [rs.randn(1, s, s, d).astype(np.float32) for s in (4, 8)]
    mf = rs.randn(1, 16, 16, d).astype(np.float32)
    valid = lambda n, k: np.arange(n) < k  # noqa: E731
    kw = dict(class_embeddings=rs.randn(5, d).astype(np.float32),
              logit_scale=np.float32(0.7),
              grounding_tokens=rs.randn(6, d).astype(np.float32), grounding_valid=valid(6, 4),
              spatial_queries=[rs.randn(5, d).astype(np.float32) for _ in range(2)],
              spatial_valid=valid(5, 3), spatial_pos_embed=rs.randn(1, 1, d).astype(np.float32),
              visual_queries=[rs.randn(4, d).astype(np.float32) for _ in range(2)],
              visual_valid=valid(4, 2), visual_pos_embed=rs.randn(1, 1, d).astype(np.float32),
              audio_tokens=rs.randn(3, d).astype(np.float32), audio_valid=valid(3, 2))
    rec = _JaxAttnMasks(monkeypatch)
    want = jdec.forward(jp["decoder"], jcfg.decoder, [jnp.asarray(m) for m in ms],
                        jnp.asarray(mf), **_tree_map(jnp.asarray, kw))
    with tdec.recording_attn_masks() as masks:
        got = tdec.forward(tp["decoder"], tcfg.decoder, [torch.from_numpy(m) for m in ms],
                           torch.from_numpy(mf), **_tree_map(torch.as_tensor, kw))
    flips, _ = _flipped(rec, masks)
    assert flips == 0
    assert len(masks) == tcfg.decoder.dec_layers + 1
    for key in ("pred_logits", "pred_masks", "pred_captions", "pred_maskembs"):
        _close(got[key], want[key])

    blocked = tdec._self_attn_mask(3, [("grounding", 2, torch.tensor([True, False])),
                                       ("spatial", 2, None), ("audio", 1, None)], "cpu")
    jblocked = jdec._self_attn_mask(3, [("grounding", 2, jnp.asarray([True, False])),
                                        ("spatial", 2, None), ("audio", 1, None)])
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(jblocked))
    pts = rs.rand(9, 2).astype(np.float32)
    _close(tdec.point_sample(torch.from_numpy(mf[0]), torch.from_numpy(pts)),
           jdec.point_sample(jnp.asarray(mf[0]), jnp.asarray(pts)))


# ------------------------------------------------------------ entry points


def _stroke(shape=(64, 64)):
    m = np.zeros(shape, bool)
    m[18:40, 22:45] = True
    return m


def _entry_args(name, jcfg):
    """(JAX args, port args) after params/cfg for each entry point."""
    import jax.numpy as jnp

    img = _image(5)
    if name in ("text", "audio"):
        ids, m = _phrase_ids(jcfg, 3)
        args = (img, ids, m)
    elif name in ("stroke", "visual", "track"):
        from vitron_tpu.models.seem import decoder as jdec

        pts, valid = jdec.sample_stroke_points(_stroke(), jcfg.decoder.max_spatial_len,
                                               np.random.RandomState(0))
        args = ((np.stack([img, _image(6), _image(7)]), img, pts, valid) if name == "track"
                else (img, pts, valid))
    else:  # panoptic: a random normalized class bank
        bank = np.random.RandomState(8).randn(5, jcfg.decoder.dim_proj).astype(np.float32)
        args = (img, bank / np.linalg.norm(bank, axis=-1, keepdims=True))
    return tuple(jnp.asarray(a) for a in args), tuple(torch.as_tensor(a) for a in args)


def _capture_forward(monkeypatch, module, store):
    orig = module.dec.forward

    def forward(*a, **kw):
        out = orig(*a, **kw)
        store.append(out)
        return out

    monkeypatch.setattr(module.dec, "forward", forward)


def _matched(out, mask):
    """Index of the query whose mask the entry point returned."""
    pm = np.asarray(out["pred_masks"][0].detach().numpy() if torch.is_tensor(out["pred_masks"])
                    else out["pred_masks"][0])
    return int(np.abs(pm - np.asarray(mask)[None]).reshape(len(pm), -1).max(-1).argmin())


@pytest.mark.parametrize("name", ["text", "audio", "stroke", "visual", "panoptic", "track"])
def test_segment_entry_points_match_jax(seem, monkeypatch, name):
    """Same matched query, mask logits within tolerance, no attention-mask
    bit flipped, for each SEEM entry point."""
    from vitron_tpu.models.seem import model as jmodel

    jcfg, tcfg, jp, tp = seem
    jargs, targs = _entry_args(name, jcfg)
    jouts, touts = [], []
    _capture_forward(monkeypatch, jmodel, jouts)
    _capture_forward(monkeypatch, tmodel, touts)
    rec = _JaxAttnMasks(monkeypatch)
    with tdec.recording_attn_masks() as masks:
        if name == "visual":
            jq = jmodel.reference_visual_queries(jp, jcfg, *jargs)
            tq = tmodel.reference_visual_queries(tp, tcfg, *targs)
            for g, w in zip(tq[0], jq[0]):
                _close(g, w)
            _close(tq[1], jq[1])
            want = jmodel.segment_visual(jp, jcfg, jargs[0], *jq)[0]
            got = tmodel.segment_visual(tp, tcfg, targs[0], *tq)[0]
        elif name == "track":
            # the JAX track_video maps over frames in one traced program, so
            # its per-frame decoder runs are held eagerly, frame by frame
            frames, ref, pts, valid = jargs
            jq = jmodel.reference_visual_queries(jp, jcfg, ref, pts, valid)
            for frame in frames:
                jmodel.segment_visual(jp, jcfg, frame, *jq)
            got = tmodel.track_video(tp, tcfg, *targs)
        else:
            fn = {"text": "segment_text", "audio": "segment_audio", "stroke": "segment_stroke",
                  "panoptic": "segment_panoptic"}[name]
            want = getattr(jmodel, fn)(jp, jcfg, *jargs)
            got = getattr(tmodel, fn)(tp, tcfg, *targs)
            if name != "panoptic":
                want, got = want[0], got[0]
    flips, _ = _flipped(rec, masks)
    assert flips == 0, f"{flips} attention-mask bits flipped"
    if name == "track":
        assert len(touts) == len(jouts) == 3
        assert got.shape == (3, 16, 16) and got.dtype == torch.bool
        for jo, to in zip(jouts, touts):
            _close(to["pred_masks"], jo["pred_masks"])
        want = jmodel.track_video(jp, jcfg, *jargs)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    if name == "panoptic":
        _close(got[0], want[0])
        _close(got[1], want[1])
        return
    (jo,), (to,) = jouts, touts
    _close(to["pred_masks"], jo["pred_masks"])
    assert _matched(to, got.numpy()) == _matched(jo, want)
    assert got.shape == (16, 16)
    _close(got, want)


def test_upsample_and_semantic_match_jax():
    import jax.numpy as jnp

    from vitron_tpu.models.seem import model as jmodel
    from vitron_tpu.models.seem import postprocess as jpp

    rs = np.random.RandomState(9)
    m = rs.randn(16, 16).astype(np.float32)
    np.testing.assert_array_equal(tmodel.upsample_mask(torch.from_numpy(m), (50, 70)).numpy(),
                                  np.asarray(jmodel.upsample_mask(jnp.asarray(m), (50, 70))))
    cls, pred = rs.randn(6, 4).astype(np.float32), rs.randn(6, 8, 8).astype(np.float32)
    _close(tpp.semantic_inference(torch.from_numpy(cls), torch.from_numpy(pred)),
           jpp.semantic_inference(jnp.asarray(cls), jnp.asarray(pred)))


def test_panoptic_and_instance_inference_match_jax():
    from vitron_tpu.models.seem import postprocess as jpp

    rs = np.random.RandomState(10)
    q, k = 12, 6
    cls = rs.randn(q, k + 1).astype(np.float32)
    cls[np.arange(8), [0, 1, 6, 3, 3, 4, 5, 1]] += 9.0  # confident queries, one void
    # each query owns a 3-column strip, with noise
    pred = rs.randn(q, 20, 24).astype(np.float32) - 6
    for i in range(8):
        pred[i, :, 3 * i:3 * i + 3] += 12
    for thing in ({0, 1, 2}, set()):
        tpan, tsegs = tpp.panoptic_inference(cls, pred, thing)
        jpan, jsegs = jpp.panoptic_inference(cls, pred, thing)
        np.testing.assert_array_equal(tpan, jpan)
        assert [dataclasses.astuple(s) for s in tsegs] == [dataclasses.astuple(s) for s in jsegs]
        assert len(tsegs) >= 2
    ti, ji = tpp.instance_inference(cls, pred, topk=10), jpp.instance_inference(cls, pred, topk=10)
    for key in ("scores", "labels", "masks"):
        np.testing.assert_array_equal(ti[key], ji[key])
    assert tpp.COCO_PANOPTIC_CLASSES == jpp.COCO_PANOPTIC_CLASSES
    assert tpp.COCO_THING_IDS == jpp.COCO_THING_IDS


def test_visualize_helpers_match_jax():
    from vitron_tpu.media import visualize as jvz
    from vitron_tpu.models.seem import postprocess as jpp
    from vitron_tpu_torch.media import visualize as tvz

    img = _image(11, (40, 48, 3))
    m = _stroke((40, 48))
    for text in (None, "the red car"):
        np.testing.assert_array_equal(tvz.draw_binary_mask(img, m, text=text),
                                      jvz.draw_binary_mask(img, m, text=text))
    pan = np.zeros((40, 48), np.int32)
    pan[:20] = 1
    pan[25:, 10:30] = 2
    segs = [jpp.PanopticSegment(1, False, 120), jpp.PanopticSegment(2, True, 2)]
    t_over, t_lab = tvz.draw_panoptic(img, pan, segs, class_names=jpp.COCO_PANOPTIC_CLASSES)
    j_over, j_lab = jvz.draw_panoptic(img, pan, segs, class_names=jpp.COCO_PANOPTIC_CLASSES)
    np.testing.assert_array_equal(t_over, j_over)
    assert t_lab == j_lab
    frames = np.stack([img, _image(12, (40, 48, 3))])
    masks = np.stack([m[::4, ::4], ~m[::4, ::4]])  # [2, 10, 12]: frames are 4x
    np.testing.assert_array_equal(tvz.masks_to_video_overlay(frames, masks),
                                  jvz.masks_to_video_overlay(frames, masks))
    # a frame that is no multiple of the mask: the port enlarges by index
    odd = tvz.masks_to_video_overlay(frames[:, :39, :47], masks)
    assert odd.shape == (2, 39, 47, 3)


# ----------------------------------------------------------------- handlers


class _FakeGligen:
    """Stands in for a GLIGEN pipeline: records generate's arguments."""

    def __init__(self, latent_size):
        self.cfg = types.SimpleNamespace(latent_size=latent_size)
        self.calls = []

    def generate(self, *args, **kw):
        self.calls.append((args, kw))
        return torch.zeros((32, 32, 3), dtype=torch.uint8)


@pytest.fixture(scope="module")
def systems(seem):
    """(JAX VitronSystem, port VitronSystem) with SEEM and a fake GLIGEN."""
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    jcfg, tcfg, jp, tp = seem
    tok = StubClipTokenizer(tcfg.lang.vocab_size)
    jsys, tsys = JSystem(None), VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30))
    jsys.register_seem(jp, jcfg, tok)
    tsys.register_seem(tp, tcfg, tok)
    jsys.register_gligen(_FakeGligen(16))
    tsys.register_gligen(_FakeGligen(16))
    return jsys, tsys


def _logit_guard(monkeypatch):
    """Records the port's upsampled mask logits (before the > 0 threshold)."""
    seen = []
    orig = tmodel.upsample_mask

    def upsample_mask(mask_logits, out_hw):
        from vitron_tpu_torch.media.preprocess import _resize_hw

        seen.append(_resize_hw(mask_logits[..., None], out_hw[0], out_hw[1], "linear")[..., 0])
        return orig(mask_logits, out_hw)

    monkeypatch.setattr(tmodel, "upsample_mask", upsample_mask)
    return seen


def _same_mask(got, want, logits):
    """Thresholded masks identical except where |logit| < 1e-4."""
    differ = got != want
    if differ.any():
        assert np.abs(logits.numpy()[differ]).max() < 1e-4, int(differ.sum())


# images at the model's input size: the handlers' resize to 512 (64 here)
# is then the identity on both sides, so both models see the same uint8
# pixels (test_handle_b_resized_input covers a resize)
IMAGE = _image(13)
SKETCH = _stroke()
B_CASES = {
    "text": ("<module>B</module><instruction>the red car</instruction>", None, None),
    "stroke": ("<module>B</module><instruction>the red car</instruction>", SKETCH, None),
    "audio": ("<module>B</module><instruction>x</instruction>", None,
              {"audio_transcript": "a dog on the grass"}),
    "audio_no_asr": ("<module>B</module><instruction>x</instruction>", None,
                     {"audio": np.zeros(16000, np.float32)}),
    "panoptic": ("<module>B</module><instruction></instruction>", None, None),
}


def _loose_panoptic(monkeypatch, seem):
    """Let the tiny random model find segments: a random class bank (its
    language encoder gives all 134 classes nearly the same embedding; the
    bank's own parity is test_language_matches_jax), a sharp class
    temperature (exp(4.6) = 100, about SEEM's trained one), and in both
    handlers' panoptic_inference a 0.3 score threshold and no occlusion
    threshold (its queries' masks overlap almost wholly)."""
    import functools

    import jax.numpy as jnp

    from vitron_tpu.models.seem import language as jlang
    from vitron_tpu.models.seem import postprocess as jpp

    jcfg, _, jp, tp = seem
    bank = np.random.RandomState(20).randn(134, jcfg.lang.dim_proj).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    monkeypatch.setattr(jlang, "class_embeddings_from_ids", lambda *a: jnp.asarray(bank))
    monkeypatch.setattr(tlang, "class_embeddings_from_ids", lambda *a: torch.from_numpy(bank))
    monkeypatch.setitem(jp["lang"], "logit_scale", jp["lang"]["logit_scale"] * 0 + 4.6)
    monkeypatch.setitem(tp["lang"], "logit_scale", torch.tensor(4.6))
    for mod in (jpp, tpp):
        monkeypatch.setattr(mod, "panoptic_inference", functools.partial(
            mod.panoptic_inference, object_mask_threshold=0.3, overlap_threshold=0.0))


@pytest.mark.parametrize("case", list(B_CASES))
def test_handle_b_matches_jax(systems, seem, monkeypatch, case):
    """Each branch of handle_b (text, stroke, audio transcript, raw audio with
    no ASR hook, 'segment all') against the JAX system's handler."""
    from vitron_tpu.runtime.router import route_model_output

    jsys, tsys = systems
    reply, sketch, extra = B_CASES[case]
    if case == "panoptic":
        _loose_panoptic(monkeypatch, seem)
    want = route_model_output(jsys.registry, reply, image=IMAGE, sketch_mask=sketch,
                              extra=dict(extra or {}))
    logits = _logit_guard(monkeypatch)
    with torch.no_grad():
        got = tsys.route(reply, image=IMAGE, sketch_mask=sketch, extra=dict(extra or {}))
    for key in ("status", "task", "text"):
        assert got[key] == want[key], key
    if case == "audio_no_asr":
        assert got["status"] == "error"
        assert got["error"].startswith("audio input but no ASR hook installed")
        assert want["error"].startswith("audio input but no ASR hook installed")
        return
    assert got["status"] == "ok"
    if case == "panoptic":
        np.testing.assert_array_equal(got["panoptic"], want["panoptic"])
        assert ([dataclasses.astuple(s) for s in got["segments"]]
                == [dataclasses.astuple(s) for s in want["segments"]])
        assert got["segments"] and got["labels"] == want["labels"]
        np.testing.assert_array_equal(got["overlay"], want["overlay"])
        return
    _same_mask(got["mask"], np.asarray(want["mask"]), logits[-1])
    assert got["mask"].shape == IMAGE.shape[:2] and got["mask"].any() and not got["mask"].all()
    if case == "audio":
        assert got["transcript"] == want["transcript"]
    np.testing.assert_array_equal(got["overlay"], want["overlay"])


def test_handle_b_resized_input(systems):
    """A 72x96 image: both handlers resize it to the input size (antialiased
    linear) and truncate to uint8. The float resizes agree to 1e-4 levels,
    but truncation turns that into a 1-level step on pixels that sit at an
    integer, so the two models see slightly different images; the masks
    agree on all but a few pixels."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu_torch.media.preprocess import _resize_hw

    jsys, tsys = systems
    image = _image(14, (72, 96, 3))
    jin = np.asarray(jax.image.resize(jnp.asarray(image, jnp.float32), (64, 64, 3),
                                      "linear").astype(jnp.uint8))
    tin = _resize_hw(torch.as_tensor(image, dtype=torch.float32), 64, 64, "linear").to(
        torch.uint8).numpy()
    step = np.abs(jin.astype(int) - tin.astype(int))
    assert step.max() <= 1 and step.mean() < 0.01
    reply = "<module>B</module><instruction>the red car</instruction>"
    want = np.asarray(route_model_output(jsys.registry, reply, image=image)["mask"])
    with torch.no_grad():
        got = tsys.route(reply, image=image)["mask"]
    assert got.shape == want.shape == (72, 96)
    assert (got != want).mean() <= 0.02, (got != want).sum()


def test_handle_e_matches_jax(systems):
    """Video tracking through the router: three 64x64 frames and a stroke."""
    from vitron_tpu.runtime.router import route_model_output

    jsys, tsys = systems
    video = np.stack([_image(15), _image(16), _image(17)])
    reply = "<module>E</module><instruction>track the car</instruction>"
    want = route_model_output(jsys.registry, reply, video=video, sketch_mask=SKETCH)
    with torch.no_grad():
        got = tsys.route(reply, video=video, sketch_mask=SKETCH)
    for key in ("status", "task", "text"):
        assert got[key] == want[key], key
    assert got["status"] == "ok" and got["masks"].shape == (3, 16, 16)
    np.testing.assert_array_equal(got["masks"], np.asarray(want["masks"]))
    np.testing.assert_array_equal(got["overlay_frames"], want["overlay_frames"])
    assert tsys.route(reply, video=video)["status"] == "error"


def test_handle_c_seem_branch_matches_jax(systems):
    """C with no sketch and no region: SEEM segments each ';'-separated
    phrase, and GLIGEN is asked for the JAX handler's boxes, phrases and
    keep-mask (outside the merged mask, at the latent size)."""
    from vitron_tpu.runtime.router import route_model_output

    jsys, tsys = systems
    reply = "<module>C</module><instruction>the red car; a dog</instruction>"
    want = route_model_output(jsys.registry, reply, image=IMAGE)
    with torch.no_grad():
        got = tsys.route(reply, image=IMAGE)
    assert got["status"] == want["status"] == "ok"
    (jargs, jkw), (targs, tkw) = _gligen_of(jsys).calls[-1], _gligen_of(tsys).calls[-1]
    assert targs[0] == jargs[0] and list(targs[2]) == list(jargs[2])
    assert len(targs[1]) == 2
    np.testing.assert_allclose(np.asarray(targs[1], np.float64), np.asarray(jargs[1], np.float64))
    np.testing.assert_array_equal(tkw["inpaint_keep_mask"], np.asarray(jkw["inpaint_keep_mask"]))
    assert 0 < tkw["inpaint_keep_mask"].sum() < tkw["inpaint_keep_mask"].size
    assert tkw["guidance_scale"] == jkw["guidance_scale"] == 30.0


def _gligen_of(system):
    """The fake GLIGEN pipeline that `system`'s C handler closes over."""
    for cell in system.registry._handlers["C"].__closure__:
        if isinstance(cell.cell_contents, _FakeGligen):
            return cell.cell_contents
    raise AssertionError("no fake pipeline in the C handler")


def test_bf16_towers_match_jax(seem):
    """compute_dtype="bfloat16" (the served setting): bf16 backbone and pixel
    decoder on both sides; the float32 mask logits agree to 3e-2 of their
    scale. Each side rounds to bf16 at its own op boundaries (JAX's eager
    gelu rounds each of its four ops, F.gelu once; the two frameworks' bf16
    matmuls and convs sum in other orders): 2.7e-2 at this seed, with the
    FocalNet outputs already 1.5-1.9e-2 apart."""
    import jax.numpy as jnp

    from vitron_tpu.models.seem import model as jmodel

    jcfg, tcfg, jp, tp = seem
    img = _image(18)
    ids, m = _phrase_ids(jcfg, 2, seed=19)
    want, _ = jmodel.segment_text(jmodel.cast_tower_params(jp),
                                  dataclasses.replace(jcfg, compute_dtype="bfloat16"),
                                  jnp.asarray(img), jnp.asarray(ids), jnp.asarray(m))
    got, _ = tmodel.segment_text(tmodel.cast_tower_params(tp),
                                 dataclasses.replace(tcfg, compute_dtype="bfloat16"),
                                 torch.as_tensor(img), torch.as_tensor(ids), torch.as_tensor(m))
    assert got.dtype == torch.float32
    _close(got, want, 3e-2)
