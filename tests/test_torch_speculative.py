"""The port's speculative decoding against the JAX package on the CPU.

At `VitronConfig.tiny()` (float32), with the JAX package's parameters
carried across by `models/convert.from_jax` and inputs from numpy seeds:
- `ngram_draft`, `_first_eos_truncate`, `spec_init_state`,
  `spec_resume_state` and `hypothetical_tpf` equal JAX's exactly;
- the verify window (`llama.decode_step` over k + 1 tokens at a
  device-held slot, on the einsum path and through the flash kernel with a
  device-held q_offset) against JAX's cached forward at a traced
  `cache.index`, and the plain flash version with a tensor q_offset against
  the int one;
- one `speculative_segment` and `speculative_decode`: tokens, emissions and
  forwards equal JAX's, the KV cache up to the frontier within the llama
  parity tests' float32 tolerance;
- `Generator.generate` in each speculative mode (at once with and without a
  stopper, the fallback, the probe that stays plain and the one that
  upgrades, VITRON_SPEC 0 and 2), "xla" and "flash": the tokens equal the
  port's plain greedy stream and JAX's plain greedy stream (never JAX's
  speculative one: ROADMAP C1), `last_spec_stats` equals JAX's where JAX runs
  its unsegmented `_get_spec_fn`, every segmented case five times over with
  the same tokens and no segment that emits nothing; an EOS computed past
  a segment's cap, emitted by the next segment (ROADMAP C1's likely cause,
  not carried over); the speculative cache's size against every slot a
  request can write; the zero-emission branch; the card's warm-up +
  replay emulated.

JAX's flash path runs its Pallas kernel in interpret mode (as its own tests
run it): `vitron_tpu.kernels.flash_attention.flash_attention` is wrapped
with `interpret=True` for the test's duration. Two parameter sets: the JAX
init (its greedy continuation is novel: prompt lookup accepts ~nothing)
and a cyclic one, in which the lm_head maps each token's normalised
embedding to a successor drawn from short cycles of the vocabulary and the
attention and MLP outputs are scaled by 3e-4, so the continuation cycles
(period 3 to 7) while the attention still moves the logits.
"""
import functools
import itertools
import zlib

import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import flash_attention as tfa
from vitron_tpu_torch.mm.splice import plan_splice
from vitron_tpu_torch.mm.tokenization import KeywordStopper
from vitron_tpu_torch.models import vitron_model as tvm
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.llm import llama as tl
from vitron_tpu_torch.runtime import generation as tgen
from vitron_tpu_torch.runtime import speculative as tsp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = ATOL = 1e-4  # float32, as tests/test_torch_llama.py
PROMPT = [1, 5, 9, 7, 5, 9, 3]
CYCLIC_SCALE = 3e-4  # the cyclic set's attention and MLP output scale
RUNS = 5  # repeats of each segmented case


@pytest.fixture(autouse=True)
def _interpret_flash(request, monkeypatch):
    if request.node.get_closest_marker("cuda"):
        return  # the card's machine has no JAX
    import vitron_tpu.kernels.flash_attention as jfa

    monkeypatch.setattr(jfa, "flash_attention",
                        functools.partial(jfa.flash_attention, interpret=True))


def _cyclic(params, seed=0):
    """The cyclic parameter set (module docstring) from JAX's numpy tree."""
    rs = np.random.RandomState(seed)
    v = params["llm"]["embed"].shape[0]
    order, succ, i = rs.permutation(v), np.empty(v, np.int64), 0
    while i < v:
        cyc = order[i:i + min(rs.randint(3, 8), v - i)]
        succ[cyc] = np.roll(cyc, -1)
        i += len(cyc)
    e = params["llm"]["embed"]
    head = np.zeros_like(params["llm"]["lm_head"])
    head[:, succ] = (e / np.linalg.norm(e, axis=1, keepdims=True)).T * 2.0
    p = dict(params, llm=dict(params["llm"], lm_head=head.astype(np.float32),
                              layers=dict(params["llm"]["layers"])))
    for name in ("wo", "down"):
        p["llm"]["layers"][name] = (params["llm"]["layers"][name] * CYCLIC_SCALE
                                    ).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def sets():
    """{"novel": JAX init params, "cyclic": the cyclic set}, numpy leaves."""
    import jax

    from vitron_tpu.models import vitron_model as jvm

    params = jax.tree.map(np.asarray, jvm.init_params(jax.random.PRNGKey(0),
                                                      jvm.VitronConfig.tiny()))
    return {"novel": params, "cyclic": _cyclic(params)}


def _cfgs(attn_impl):
    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.models.llm import llama as jl

    return (jvm.VitronConfig.tiny(llm=jl.LlamaConfig.tiny(attn_impl=attn_impl)),
            tvm.VitronConfig.tiny(llm=tl.LlamaConfig.tiny(attn_impl=attn_impl)))


def _plan(row=PROMPT):
    return plan_splice([row], [], 64, image_len=16)


class _IdTok:
    """An id tokenizer for a KeywordStopper that never fires: each word maps
    to an id past every vocabulary here, so no emitted token matches it.
    (The JAX tests' copy maps words by `hash`, which PYTHONHASHSEED changes
    from process to process, into ids that the model can emit: ROADMAP C1.)"""
    bos_token_id = 1
    eos_token_id = 2

    def __call__(self, s):
        class R:
            pass

        r = R()
        r.input_ids = [1] + [1_000_000 + zlib.crc32(w.encode()) % 1000 for w in s.split()]
        return r

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(t) for t in ids)


def _stopper():
    return KeywordStopper(["no-such-stop-string"], _IdTok(), prompt_len=0)


def _jax_stopper():
    from vitron_tpu.mm.tokenization import KeywordStopper as JaxStopper

    return JaxStopper(["no-such-stop-string"], _IdTok(), prompt_len=0)


# ------------------------------------------------------------ host pieces

DRAFT_CASES = {
    # history, hist_len, last_token, k, ngram
    "no_match": ([1, 2, 3, 4, 0, 0], 4, 4, 3, 2),
    "tail_self_match_excluded": ([5, 6, 7, 8, 5, 6, 0, 0], 6, 6, 3, 2),
    "most_recent_match": ([3, 4, 9, 9, 3, 4, 1, 2, 3, 4, 0, 0], 10, 4, 2, 2),
    "continuation_past_hist_len": ([7, 8, 1, 7, 8, 5, 5, 9, 9, 9], 5, 8, 4, 2),
    "stale_tail_read": ([2, 3, 4, 2, 3, 6, 6, 6, 0, 0, 0], 5, 3, 4, 2),
    "trigram": ([1, 2, 3, 9, 1, 2, 3, 0, 0, 0], 7, 3, 3, 3),
}


@pytest.mark.parametrize("case", sorted(DRAFT_CASES))
def test_ngram_draft_matches_jax(case):
    import jax.numpy as jnp

    from vitron_tpu.runtime.speculative import ngram_draft

    hist, n, last, k, ngram = DRAFT_CASES[case]
    want = ngram_draft(jnp.asarray(hist, jnp.int32), jnp.int32(n), jnp.int32(last), k, ngram)
    got = tsp.ngram_draft(torch.tensor(hist), torch.tensor([n]), torch.tensor([last]), k, ngram)
    assert got.tolist() == np.asarray(want).tolist()


def test_ngram_draft_random_histories_match_jax():
    import jax.numpy as jnp

    from vitron_tpu.runtime.speculative import ngram_draft

    rs = np.random.RandomState(0)
    for _ in range(40):
        hist = rs.randint(0, 4, 24)
        n, k, ngram = int(rs.randint(2, 24)), int(rs.randint(1, 6)), int(rs.randint(1, 4))
        want = ngram_draft(jnp.asarray(hist, jnp.int32), jnp.int32(n), jnp.int32(hist[n - 1]),
                           k, ngram)
        got = tsp.ngram_draft(torch.from_numpy(hist).long(), torch.tensor([n]),
                              torch.tensor([int(hist[n - 1])]), k, ngram)
        assert got.tolist() == np.asarray(want).tolist(), (hist, n, k, ngram)


def test_first_eos_truncate_matches_jax():
    """EOS at each emittable slot (and past the accepted prefix) for every
    accepted count, with one and two EOS ids."""
    import jax.numpy as jnp

    from vitron_tpu.runtime.speculative import _first_eos_truncate

    k = 4
    for eos in ((2,), (2, 7)):
        for acc in range(k + 1):
            for at in range(-1, k + 1):
                g = np.full(k + 1, 11)
                if at >= 0:
                    g[at] = eos[-1]
                n_j, e_j = _first_eos_truncate(jnp.asarray(g, jnp.int32), jnp.int32(acc),
                                               jnp.asarray(eos, jnp.int32))
                n_t, e_t = tsp._first_eos_truncate(torch.from_numpy(g).long(),
                                                   torch.tensor(acc),
                                                   tsp.eos_tensor(eos, "cpu"))
                assert (int(n_t), bool(e_t)) == (int(n_j), bool(e_j)), (eos, acc, at)


def _state_ints(st):
    return [st.last_tok.tolist()[0], st.slot.tolist()[0], st.pos.tolist()[0],
            st.history.tolist(), st.hist_len.tolist()[0], bool(st.done), st.steps.tolist()[0]]


def _jax_state_ints(st):
    last, slot, pos, _, _, _, hist, n, done, steps = st
    return [int(last), int(slot), int(pos), np.asarray(hist).tolist(), int(n), bool(done),
            int(steps)]


@pytest.mark.parametrize("tok0", [11, 2])
def test_spec_init_state_matches_jax(tok0):
    import jax.numpy as jnp

    from vitron_tpu.models.llm import llama as jl
    from vitron_tpu.runtime import speculative as jsp

    prompt = np.asarray([1, 5, 9, 7, 0, 0, 0, 0, 0], np.int32)
    cache = jl.KVCache.create(jl.LlamaConfig.tiny(), 1, max_len=32)
    cache = jl.KVCache(k=cache.k, v=cache.v, index=jnp.int32(9), valid=cache.valid)
    want = jsp.spec_init_state(jnp.int32(tok0), cache, jnp.asarray(prompt), jnp.int32(4), 12, 4,
                               (2,))
    got = tsp.spec_init_state(tok0, 9, prompt, 4, 12, 4, (2,), device="cpu")
    assert _state_ints(got) == _jax_state_ints(want)


def test_spec_resume_state_matches_jax():
    from vitron_tpu.models.llm import llama as jl
    from vitron_tpu.runtime import speculative as jsp

    prompt = np.asarray([1, 5, 9, 7, 3, 0, 0, 0], np.int32)
    emitted = [21, 22, 23, 21, 22]
    cache = jl.KVCache.create(jl.LlamaConfig.tiny(), 1, max_len=32)
    want = jsp.spec_resume_state(emitted[-1], cache, prompt, 5, emitted, 16, 4)
    got = tsp.spec_resume_state(emitted[-1], 0, prompt, 5, emitted, 16, 4, device="cpu")
    assert _state_ints(got) == _jax_state_ints(want)
    # into a longer buffer of a graph: the same prefix, zeros past it, reset
    # whatever the previous request left there
    out = tsp.SpecState.create(64, 4, "cpu")
    out.history.fill_(99)
    tsp.spec_resume_state(emitted[-1], 0, prompt, 5, emitted, 16, 4, out=out)
    n = len(_jax_state_ints(want)[3])
    assert out.history[:n].tolist() == _jax_state_ints(want)[3]
    assert out.history[n:].eq(0).all()


def test_hypothetical_tpf_matches_jax():
    """Repetitive, novel and random emissions: the same float as JAX."""
    from vitron_tpu.runtime.speculative import hypothetical_tpf

    prompt = np.asarray([1, 5, 9, 7, 0, 0, 0, 0], np.int32)
    rs = np.random.RandomState(0)
    seqs = [[3, 4, 6] * 6, [11, 23, 37, 41, 53, 67, 71, 83, 97, 13, 17, 19],
            [5, 9, 7, 5, 9, 7, 5, 9, 2]] + [list(rs.randint(0, 6, 30)) for _ in range(10)]
    values = []
    for emitted in seqs:
        for k, ngram in ((4, 2), (2, 1), (3, 3)):
            want = hypothetical_tpf(prompt, 4, emitted, k=k, ngram=ngram)
            got = tsp.hypothetical_tpf(prompt, 4, emitted, k=k, ngram=ngram)
            assert got == want, (emitted, k, ngram)
            values.append(got)
    assert tsp.hypothetical_tpf(prompt, 4, seqs[0]) > 2.0 >= 1.0 >= tsp.hypothetical_tpf(
        prompt, 4, seqs[1])
    assert len(set(values)) > 5


# ------------------------------------------------------- the verify window

@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_verify_window_at_device_index_matches_jax(sets, attn_impl):
    """A prefill, then two windows of k + 1 = 5 tokens at a slot held in a
    device tensor (the second over the first's stale tail): the logits and
    the cache equal JAX's cached forward at a traced cache.index."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.llm import llama as jl

    jcfg, cfg = _cfgs(attn_impl)
    params = sets["novel"]
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 256, (1, 7)).astype(np.int32)
    pos = np.arange(7, dtype=np.int32)[None]
    jp = jax.tree.map(jnp.asarray, params["llm"])
    tp = from_jax(params["llm"], "cpu")
    jcache = jl.KVCache.create(jcfg.llm, 1, max_len=24)
    _, jcache = jl.forward_tokens(jp, jcfg.llm, jnp.asarray(ids), positions=jnp.asarray(pos),
                                  cache=jcache)
    cache = tl.KVCache.create(cfg.llm, 1, max_len=24)
    tl.forward_tokens(tp, cfg.llm, torch.from_numpy(ids).long(),
                      positions=torch.from_numpy(pos.copy()).long(), cache=cache)
    index = torch.tensor([7])
    for start in (7, 9):  # the second window rewrites slots 9-11 of the first
        win = rs.randint(0, 256, (1, 5)).astype(np.int32)
        wpos = np.arange(start, start + 5, dtype=np.int32)[None]
        jcache = jl.KVCache(k=jcache.k, v=jcache.v, index=jnp.int32(start), valid=jcache.valid)
        want, jcache = jl.forward_tokens(jp, jcfg.llm, jnp.asarray(win),
                                         positions=jnp.asarray(wpos), cache=jcache)
        index.fill_(start)
        got, _ = tl.decode_step(tp, cfg.llm, tp["embed"][torch.from_numpy(win).long()],
                                torch.from_numpy(wpos.copy()).long(), cache, index)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cache.valid.numpy(), np.asarray(jcache.valid))
    assert cache.index == 7  # the host fill level is the caller's


def test_plain_flash_takes_a_device_offset():
    """The plain flash version with q_offset as a [1] int64 tensor equals
    the int form, and both equal JAX's interpret-mode kernel at that
    offset (kv_mask with holes, GQA)."""
    import jax.numpy as jnp

    import vitron_tpu.kernels.flash_attention as jfa

    rs = np.random.RandomState(0)
    q = rs.randn(2, 5, 4, 16).astype(np.float32)
    k = rs.randn(2, 40, 2, 16).astype(np.float32)
    v = rs.randn(2, 40, 2, 16).astype(np.float32)
    mask = rs.rand(2, 40) > 0.2
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    for off in (0, 17, 35):
        want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              kv_mask=jnp.asarray(mask),
                                              q_offset=jnp.asarray([off], jnp.int32)))
        by_int = tfa.flash_attention(tq, tk, tv, kv_mask=tm, q_offset=off)
        by_tensor = tfa.flash_attention(tq, tk, tv, kv_mask=tm, q_offset=torch.tensor([off]))
        np.testing.assert_array_equal(by_tensor.numpy(), by_int.numpy())
        np.testing.assert_allclose(by_tensor.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(TypeError, match="int64"):
        tfa.flash_attention(tq, tk, tv, q_offset=torch.tensor([1], dtype=torch.int32))


# ------------------------------------------------------------ one segment

@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_speculative_segment_matches_jax(sets, attn_impl):
    """After the same prefill, one segment of 24 tokens on the cyclic set:
    tokens, emissions, forwards and the history buffer equal JAX's; the K/V
    cache up to the frontier within 1e-4."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.models.llm import llama as jl
    from vitron_tpu.runtime import speculative as jsp

    jcfg, cfg = _cfgs(attn_impl)
    params = sets["cyclic"]
    plan = _plan()
    n_new, k, seg = 40, 4, 24
    arrays = (plan.token_ids, plan.media_idx, plan.use_media, plan.position_ids,
              plan.attention_mask)
    jp = jax.tree.map(jnp.asarray, params)
    t_max = plan.token_ids.shape[1] + n_new + k + 1
    jcache = jl.KVCache.create(jcfg.llm, 1, max_len=t_max)
    logits, jcache = jvm.forward(jp, jcfg, *(jnp.asarray(a) for a in arrays), cache=jcache)
    seq_len = int(plan.seq_lens[0])
    tok0 = int(np.asarray(logits)[0, seq_len - 1].argmax())
    jstate = jsp.spec_init_state(jnp.int32(tok0), jcache, jnp.asarray(plan.token_ids[0]),
                                 jnp.int32(seq_len), n_new, k, (2,))
    jtoks, jn, jsteps, jstate = jsp.speculative_segment(jp, jcfg, jstate, seg, jnp.int32(30),
                                                        k=k, eos_ids=(2,))

    tp = from_jax(params, "cpu")
    cache = tl.KVCache.create(cfg.llm, 1, max_len=t_max)
    gen_ = tgen.Generator(tp, cfg)
    first = gen_._prefill(cache, *arrays, plan.seq_lens)
    assert int(first[0].argmax()) == tok0
    state = tsp.spec_init_state(tok0, cache.index, plan.token_ids[0], seq_len, n_new, k, (2,),
                                device="cpu")
    toks, n, steps, state = tsp.speculative_segment(tp, cfg, state, cache, seg, 30, k=k,
                                                    eos_ids=(2,))
    assert toks.tolist() == np.asarray(jtoks).tolist()
    assert (n, steps) == (int(jn), int(jsteps))
    assert n == seg and steps < seg // 2  # the cyclic set's drafts are accepted
    assert _state_ints(state)[:6] == _jax_state_ints(jstate)[:6]
    front = int(state.slot)
    np.testing.assert_allclose(cache.k[:, :, :front].numpy(), np.asarray(jstate[3])[:, :, :front],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache.v[:, :, :front].numpy(), np.asarray(jstate[4])[:, :, :front],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["novel", "cyclic"])
def test_speculative_decode_matches_jax(sets, which):
    """speculative_decode (prefill + the whole budget as one segment) on
    both sets: tokens, emissions and forwards equal JAX's, and the tokens
    equal JAX's plain greedy generate_scan; EOS cuts the stream."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.runtime.generation import generate_scan
    from vitron_tpu.runtime.speculative import speculative_decode

    jcfg, cfg = _cfgs("xla")
    params = sets[which]
    plan = _plan()
    arrays = (plan.token_ids, plan.media_idx, plan.use_media, plan.position_ids,
              plan.attention_mask, plan.seq_lens)
    jp = jax.tree.map(jnp.asarray, params)
    jarrays = tuple(jnp.asarray(a) for a in arrays)
    plain = np.asarray(generate_scan(jp, jcfg, jarrays, 32, jax.random.PRNGKey(0)))[0]
    tp = from_jax(params, "cpu")
    for eos in ((), (int(plain[9]),)):
        want = speculative_decode(jp, jcfg, jarrays, 32, k=4, eos_ids=eos)
        got = tsp.speculative_decode(tp, cfg, arrays, 32, k=4, eos_ids=eos)
        assert got[0].tolist() == np.asarray(want[0]).tolist()
        assert (got[1], got[2]) == (int(want[1]), int(want[2]))
    assert tsp.speculative_decode(tp, cfg, arrays, 32, k=4, eos_ids=())[0].tolist() == \
        plain.tolist()
    with pytest.raises(ValueError, match="single-stream"):
        two = plan_splice([PROMPT, PROMPT[:4]], [], 64, image_len=16)
        tsp.speculative_decode(tp, cfg, (two.token_ids, two.media_idx, two.use_media,
                                         two.position_ids, two.attention_mask,
                                         two.seq_lens), 8)


# ------------------------------------------------------ Generator.generate

# name: (parameter set, env, generate kwargs, max_new_tokens, stopper,
#        speculation mode expected, JAX runs it unsegmented)
GEN_CASES = {
    "at_once": ("cyclic", {}, dict(speculative=True), 40, False, "spec", True),
    "at_once_novel": ("novel", {}, dict(speculative=True), 24, False, "spec", True),
    "segments_stopper": ("cyclic", {}, dict(speculative=True, decode_chunk=16), 48, True,
                         "segments", False),
    "fallback": ("novel", {"VITRON_SPEC_TPF_MIN": "1000"},
                 dict(speculative=True, decode_chunk=8), 48, True, "fell_back", False),
    "probe_stays_plain": ("cyclic", {"VITRON_SPEC": "1", "VITRON_SPEC_TPF_MIN": "1000"},
                          dict(decode_chunk=16), 48, False, "probe_plain", False),
    "probe_upgrades": ("cyclic", {"VITRON_SPEC": "1"}, dict(decode_chunk=16), 48, True,
                       "probe_spec", False),
    "env_off": ("cyclic", {"VITRON_SPEC": "0"}, dict(decode_chunk=16), 24, False, "none",
                False),
    "env_at_once": ("cyclic", {"VITRON_SPEC": "2"}, dict(decode_chunk=16), 24, False, "spec",
                    True),
}


@pytest.fixture(scope="module")
def jax_plain():
    """JAX's plain greedy stream (per-token steps) by (set, attn_impl, budget)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.runtime.generation import Generator, SamplingConfig

    out = {}

    def get(sets, which, attn_impl, n):
        key = (which, attn_impl, n)
        if key not in out:
            jcfg, _ = _cfgs(attn_impl)
            g = Generator(jax.tree.map(jnp.asarray, sets[which]), jcfg)
            out[key] = g.generate(_plan(), sampling=SamplingConfig(greedy=True,
                                                                   max_new_tokens=n,
                                                                   eos_ids=()),
                                  speculative=False, decode_chunk=0)[0]
        return out[key]

    return get


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_matches_plain_and_jax(sets, jax_plain, monkeypatch, case, attn_impl):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.runtime.generation import Generator as JaxGenerator
    from vitron_tpu.runtime.generation import SamplingConfig as JaxSampling

    which, env, kw, n_new, with_stopper, mode, unsegmented = GEN_CASES[case]
    for name in ("VITRON_SPEC", "VITRON_SPEC_TPF_MIN"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jcfg, cfg = _cfgs(attn_impl)
    g = tgen.Generator(from_jax(sets[which], "cpu"), cfg)
    s = tgen.SamplingConfig(greedy=True, max_new_tokens=n_new, eos_ids=())
    plain = g.generate(_plan(), sampling=s, speculative=False, decode_chunk=0)[0]
    assert plain == jax_plain(sets, which, attn_impl, n_new)
    runs = []
    for _ in range(RUNS if mode in ("segments", "fell_back", "probe_spec") else 1):
        got = g.generate(_plan(), sampling=s, stopper=_stopper() if with_stopper else None,
                         **kw)[0]
        runs.append((got, dict(g.last_spec_stats or {})))
    assert all(r == runs[0] for r in runs)
    got, stats = runs[0]
    assert got == plain
    assert g.zero_emission_segments == 0
    assert all(seg[0] > 0 for seg in g.last_spec_segments)
    if mode == "none":
        assert g.last_spec_stats is None
    elif mode.startswith("probe"):
        assert stats["mode"] == mode and stats["fell_back"] is False
    elif mode == "fell_back":
        assert stats["fell_back"] is True
    elif mode == "segments":
        assert stats["fell_back"] is False and stats["forwards"] < n_new // 2
    if mode in ("probe_spec", "segments"):
        assert len(g.last_spec_segments) >= 1
    if unsegmented:  # JAX's `_get_spec_fn` path: the same counts
        jg = JaxGenerator(jax.tree.map(jnp.asarray, sets[which]), jcfg)
        jout = jg.generate(_plan(), sampling=JaxSampling(greedy=True, max_new_tokens=n_new,
                                                         eos_ids=()), **kw)[0]
        assert jout == got
        assert stats == jg.last_spec_stats


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_eos_past_a_segments_cap_is_emitted(sets, monkeypatch, attn_impl):
    """An EOS that a verify forward computes past its segment's budget is
    not kept by that forward; the stream is not done, and the next segment
    emits it. The prompt holds the cyclic continuation, so the first
    forward accepts every draft; segments of 2 and 3 tokens cut its 5
    emittable tokens, and each token of the cycle in turn is the EOS. The
    tokens equal the port's and JAX's plain greedy streams with that EOS,
    five runs out of five (JAX's own segments set done at such an EOS and
    drop it: ROADMAP C1)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.runtime.generation import Generator as JaxGenerator
    from vitron_tpu.runtime.generation import SamplingConfig as JaxSampling

    monkeypatch.setenv("VITRON_SPEC_TPF_MIN", "0")
    jcfg, cfg = _cfgs(attn_impl)
    g = tgen.Generator(from_jax(sets["cyclic"], "cpu"), cfg)
    jg = JaxGenerator(jax.tree.map(jnp.asarray, sets["cyclic"]), jcfg)
    n_new = 16
    cycle = g.generate(_plan(), sampling=tgen.SamplingConfig(greedy=True, max_new_tokens=n_new,
                                                             eos_ids=()),
                       speculative=False, decode_chunk=0)[0]
    prompt = PROMPT + cycle[:12]
    past_cap = 0
    for at in range(1, 6):
        eos = (cycle[at],)
        assert eos[0] not in cycle[:at]
        s = tgen.SamplingConfig(greedy=True, max_new_tokens=n_new, eos_ids=eos)
        want = g.generate(_plan(prompt), sampling=s, speculative=False, decode_chunk=0)[0]
        assert want == cycle[:at + 1]
        assert want == jg.generate(_plan(prompt), sampling=JaxSampling(
            greedy=True, max_new_tokens=n_new, eos_ids=eos), speculative=False,
            decode_chunk=0)[0]
        for seg in (2, 3):
            monkeypatch.setattr(tgen, "SPEC_SEGMENT", seg)
            for _ in range(RUNS):
                got = g.generate(_plan(prompt), sampling=s, speculative=True,
                                 stopper=_stopper(), decode_chunk=16)[0]
                assert got == want, (at, seg)
                # one forward, its emissions cut at the EOS or at the cap
                assert g.last_spec_segments[0] == (min(at, seg), 1, 1)
            past_cap += at > seg
    assert g.zero_emission_segments == 0
    assert past_cap == 5  # cases whose EOS lay past the first segment's cap


def test_spec_cache_need_covers_every_write():
    """`spec_cache_need` against every slot a speculative request can
    write: the verify window (k + 1 slots from the last token's, while the
    budget is not met) and, for segments, whole plain chunks after a
    fallback at any frontier; where the probe's first chunk covers the
    budget, exactly the plain path's need."""
    for pad_len, max_new, n, k in itertools.product((7, 64, 384), (2, 17, 64, 65, 129, 300),
                                                    (8, 16, 128), (1, 4)):
        plain = pad_len + -(-(max_new - 1) // n) * n
        window = pad_len + max_new - 2 + k + 1  # the last active forward's slots
        fallback = max(pad_len + r - 1 + -(-(max_new - r) // n) * n for r in range(1, max_new))
        for probe, segmented in ((False, False), (False, True), (True, True)):
            need = tgen.spec_cache_need(pad_len, max_new, n, k, probe, segmented)
            if probe and max_new - 1 <= n:
                assert need == plain
                continue
            assert need >= max(plain, window) and (not segmented or need >= fallback)
    # a 128-token chat at a 384-slot pad: the plain path's 512 slots
    assert tgen.cache_slots(tgen.spec_cache_need(384, 128, 128, 4, True, True)) == 512


def test_probe_that_cannot_upgrade_keeps_the_plain_cache(sets, monkeypatch):
    """A default-policy request whose first plain chunk covers its budget
    decodes on the same chunk and cache as the request at VITRON_SPEC=0,
    with the same tokens."""
    monkeypatch.setattr(tgen, "MIN_CACHE_SLOTS", 16)
    _, cfg = _cfgs("xla")
    g = tgen.Generator(from_jax(sets["cyclic"], "cpu"), cfg)
    s = tgen.SamplingConfig(greedy=True, max_new_tokens=64, eos_ids=())
    monkeypatch.setenv("VITRON_SPEC", "0")
    plain = g.generate(_plan(), sampling=s, decode_chunk=64)[0]
    plain_chunk = g.last_chunk
    monkeypatch.setenv("VITRON_SPEC", "1")
    assert g.generate(_plan(), sampling=s, decode_chunk=64)[0] == plain
    assert g.last_spec_stats["mode"] == "probe_plain"
    assert g.last_chunk is plain_chunk and plain_chunk.cache.k.shape[2] == 128


def test_zero_emission_segment_falls_back_plain(sets, monkeypatch):
    """A segment that emits nothing without the stream being done (the
    JAX package's defensive branch): the request finishes as plain chunks
    on the exact frontier, and the branch is counted."""
    monkeypatch.setenv("VITRON_SPEC_TPF_MIN", "0")
    _, cfg = _cfgs("xla")
    g = tgen.Generator(from_jax(sets["cyclic"], "cpu"), cfg)
    s = tgen.SamplingConfig(greedy=True, max_new_tokens=40, eos_ids=())
    ref = g.generate(_plan(), sampling=s, speculative=False, decode_chunk=16)[0]
    real, calls = g._spec_segment, []

    def poisoned(spec, seg, limit):
        calls.append(seg)
        if len(calls) == 1:  # the first segment: nothing emitted, not done
            return [], 0, 0, False
        return real(spec, seg, limit)

    monkeypatch.setattr(g, "_spec_segment", poisoned)
    out = g.generate(_plan(), sampling=s, speculative=True, stopper=_stopper(), decode_chunk=16)
    assert out[0] == ref
    assert g.last_spec_stats["fell_back"] is True
    assert g.zero_emission_segments == 1


def test_spec_warmup_then_replay_gives_the_same_tokens(sets, monkeypatch):
    """The card's first call of a graph runs its warm-up forward, then the
    captured forwards. Emulated here (warm-up, then the body as the
    replay): the tokens and the stats equal the eager run's, so the warm-up
    puts back every state buffer it advances."""
    from vitron_tpu_torch.runtime import graphs

    _, cfg = _cfgs("xla")
    s = tgen.SamplingConfig(greedy=True, max_new_tokens=40, eos_ids=())
    monkeypatch.setattr(tgen, "SPEC_FORWARDS", 4)

    def run():
        g = tgen.Generator(from_jax(sets["cyclic"], "cpu"), cfg)
        outs = [g.generate(_plan(), sampling=s, speculative=True, stopper=stopper,
                           decode_chunk=16)[0] for stopper in (None, _stopper())]
        return outs, g.last_spec_stats, g.last_spec_segments

    eager = run()

    def emulated(self):
        if not getattr(self, "_captured", False):
            self.warmup()
            self._captured = True
        self.body()

    monkeypatch.setattr(graphs.Chunk, "__call__", emulated)
    assert run() == eager
    assert eager[0][0] == eager[0][1]
    # a replay of F = 4 forwards: the segments' replays cover their forwards
    assert eager[2] and all(r == -(-steps // 4) for _, steps, r in eager[2])


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", list(tfa.KERNEL_HEAD_DIMS))
def test_device_offset_kernel_matches_host_offset(cuda, d, dtype):
    """B2 with q_offset read from a [1] int64 tensor on the card: the same
    bits as the host-int launch, and each query row within the smoke's limit
    of the plain version (bf16: FLASH_ROW_REL of the row's largest; float32:
    1e-4), for a 5-query verify window over a holed kv_mask at several
    offsets, GQA at D 64/128."""
    import chip_smoke

    g = torch.Generator(device=cuda).manual_seed(d)
    kh = 2 if d in (64, 128) else 4
    t = 300
    mask = torch.rand((2, t), generator=g, device=cuda) > 0.1
    for off in (0, 131, 295):
        q = torch.randn((2, 5, 4, d), generator=g, device=cuda).to(dtype)
        k, v = (torch.randn((2, t, kh, d), generator=g, device=cuda).to(dtype)
                for _ in range(2))
        by_tensor = tfa.flash_attention(q, k, v, kv_mask=mask,
                                        q_offset=torch.tensor([off], device=cuda))
        by_int = tfa.flash_attention(q, k, v, kv_mask=mask, q_offset=off)
        assert torch.equal(by_tensor, by_int)
        want = tfa.flash_attention_plain(q, k, v, kv_mask=mask, q_offset=off)
        limit = chip_smoke.FLASH_ROW_REL if dtype == torch.bfloat16 else 1e-4
        assert chip_smoke.flash_row_rel(by_tensor, want) <= limit


@pytest.mark.cuda
def test_device_offset_moves_in_a_graph_replay(cuda):
    """A CUDA graph captured once replays the window at the offset the
    device tensor holds at replay time."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, 5, 32, 128), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((1, 512, 32, 128), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    mask = torch.ones((1, 512), dtype=torch.bool, device=cuda)
    off = torch.tensor([10], device=cuda)
    tfa.flash_attention(q, k, v, kv_mask=mask, q_offset=off)  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tfa.flash_attention(q, k, v, kv_mask=mask, q_offset=off)
    for slot in (10, 200, 507):
        off.fill_(slot)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tfa.flash_attention(q, k, v, kv_mask=mask, q_offset=slot))


@pytest.mark.cuda
def test_spec_replays_match_eager_on_the_card(cuda, monkeypatch):
    """On the card a speculative segment replays a graph of F verify
    forwards (B1 at M 5, B2 with its offset on the device): the tokens and
    stats equal the same forwards run eagerly, and the graph records F x
    (7 L + 1) B1 and F x L B2 launches. (Against the plain stream this bf16
    model may break a near-tied argmax the other way: the smoke's phase 6c
    judges that at full width with `check_divergence`.)"""
    from vitron_tpu_torch.kernels.quantization import quantize_llama
    from vitron_tpu_torch.runtime import graphs

    cfg = tvm.VitronConfig.tiny(llm=tl.LlamaConfig.tiny(
        hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=4, attn_impl="flash",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16))
    params = tvm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    params["llm"] = quantize_llama(params["llm"], bits=4, head=True)
    s = tgen.SamplingConfig(greedy=True, max_new_tokens=40, eos_ids=())
    monkeypatch.setattr(tgen, "SPEC_FORWARDS", 4)

    def run():
        g = tgen.Generator(params, cfg)
        plain = g.generate(_plan(), sampling=s, speculative=False, decode_chunk=16)[0]
        outs = [(g.generate(_plan(), sampling=s, speculative=True, stopper=stopper,
                            decode_chunk=16)[0], dict(g.last_spec_stats))
                for stopper in (None, _stopper())]
        torch.cuda.synchronize()
        return plain, outs, g

    plain, got, g = run()
    assert all(len(toks) == len(plain) for toks, _ in got)
    spec = g.last_chunk.spec[(4, 2, (), 4)]
    n = cfg.llm.num_layers
    assert spec.run.graph is not None
    assert spec.run.launches == {("int4_matmul", "launches"): 4 * (7 * n + 1),
                                 ("flash_attention", "launches"): 4 * n}
    monkeypatch.setattr(graphs.Chunk, "__call__", lambda self: self.body())
    plain_eager, want, _ = run()
    assert got == want and plain == plain_eager
