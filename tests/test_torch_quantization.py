"""Parity of the PyTorch port's int8/int4 quantization with the JAX package,
and of the hand CUDA int4 kernel with its plain version (on a card).

Inputs are numpy arrays from a seeded RandomState handed to both packages;
float32 tolerance rtol=atol=1e-4 unless stated. JAX is imported inside the
parity tests, so the `cuda` tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import int4_matmul as i4
from vitron_tpu_torch.kernels import quantization as tq

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def jq():
    from vitron_tpu.kernels import quantization

    return quantization


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(8, 6), (3, 16, 10)])
@pytest.mark.parametrize("bits", [8, 4])
def test_packing_bit_exact(jq, shape, bits):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.1
    import jax.numpy as jnp

    if bits == 8:
        want, got, key = jq.quantize_int8(jnp.asarray(w)), tq.quantize_int8(_t(w)), "q"
    else:
        want, got, key = jq.quantize_int4(jnp.asarray(w)), tq.quantize_int4(_t(w)), "q4"
    np.testing.assert_array_equal(got[key].numpy(), _np(want[key]))
    np.testing.assert_allclose(got["s"].numpy(), _np(want["s"]), rtol=1e-6)
    np.testing.assert_allclose(tq.dequantize(got).numpy(), _np(jq.dequantize(want)),
                               rtol=RTOL, atol=ATOL)


def test_unpack_int4_matches_jax(jq):
    packed = np.random.RandomState(1).randint(-128, 128, (2, 5, 7)).astype(np.int8)
    import jax.numpy as jnp

    np.testing.assert_array_equal(i4.unpack_int4(_t(packed)).numpy(),
                                  _np(jq._unpack_int4(jnp.asarray(packed))))


def _weight(kind, rs, k, n, jq):
    import jax.numpy as jnp

    w = rs.randn(k, n).astype(np.float32) * 0.1
    if kind == "plain":
        return w
    leaf = {k2: _np(v) for k2, v in (jq.quantize_int8 if "int8" in kind
                                     else jq.quantize_int4)(jnp.asarray(w)).items()}
    if "lora" in kind:
        leaf.update(lora_a=rs.randn(k, 3).astype(np.float32) * 0.1,
                    lora_b=rs.randn(3, n).astype(np.float32) * 0.1,
                    lora_scale=np.float32(0.5))
    return leaf


@pytest.mark.parametrize("kind", ["plain", "int8", "int4", "int8_lora", "int4_lora"])
def test_matmul_maybe_quantized_matches_jax(jq, kind):
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 32).astype(np.float32)
    w = _weight(kind, rs, 32, 24, jq)
    if isinstance(w, dict):
        jw, tw = {k: jnp.asarray(v) for k, v in w.items()}, {k: _t(v) for k, v in w.items()}
    else:
        jw, tw = jnp.asarray(w), _t(w)
    want = _np(jq.matmul_maybe_quantized(jnp.asarray(x), jw))
    got = tq.matmul_maybe_quantized(_t(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_stacked_int4_dequantizes_plainly(jq):
    """A >= 3-D int4 leaf (not indexed by a layer loop) takes the plain
    unpack path, as in the JAX package off the TPU."""
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    w = rs.randn(2, 16, 8).astype(np.float32)
    x = rs.randn(2, 5, 16).astype(np.float32)
    jw = jq.quantize_int4(jnp.asarray(w))
    want = _np(jq.matmul_maybe_quantized(jnp.asarray(x), jw))
    got = tq.matmul_maybe_quantized(_t(x), {k: _t(_np(v)) for k, v in jw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_int4_matmul_plain_matches_pallas_interpret():
    import jax.numpy as jnp

    from vitron_tpu.kernels.int4_matmul import int4_matmul as jax_int4_matmul
    from vitron_tpu.kernels.quantization import quantize_int4

    rs = np.random.RandomState(0)
    x = rs.randn(3, 64).astype(np.float32)
    q4 = {k: _np(v) for k, v in quantize_int4(jnp.asarray(
        rs.randn(64, 96).astype(np.float32) * 0.1)).items()}
    want = jax_int4_matmul(jnp.asarray(x), jnp.asarray(q4["q4"]), jnp.asarray(q4["s"]),
                           block_n=32, block_k2=16, interpret=True)
    before = i4.launches
    got = i4.int4_matmul(_t(x), _t(q4["q4"]), _t(q4["s"]))
    assert i4.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-4, atol=2e-4)


def test_quantize_llama_matches_jax(jq):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.llm import llama as jllama
    from vitron_tpu_torch.models.convert import from_jax

    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0),
                                                         jllama.LlamaConfig.tiny()))
    want = jq.quantize_llama(jax.tree.map(jnp.asarray, params), bits=4, head=True)
    got = tq.quantize_llama(from_jax(params, "cpu"), bits=4, head=True)
    for name in ("wq", "down"):
        np.testing.assert_array_equal(got["layers"][name]["q4"].numpy(),
                                      _np(want["layers"][name]["q4"]))
    np.testing.assert_array_equal(got["lm_head"]["q4"].numpy(), _np(want["lm_head"]["q4"]))


@pytest.mark.parametrize("key", ["q8", "qa8"])
def test_w8a8_w4a8_not_ported(key):
    with pytest.raises(NotImplementedError, match="A17"):
        tq.matmul_maybe_quantized(torch.zeros(2, 4),
                                  {key: torch.zeros(4, 4, dtype=torch.int8),
                                   "s": torch.ones(1, 4)})


def _byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's __byte_perm(x, y, sel) on int64 tensors of 32-bit words: byte n
    of the result is byte (sel >> 4n) & 7 of the eight bytes of x, y."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _unpack_tensor_core(words: torch.Tensor, j: int):
    """The tensor-core GEMM's unpack of byte j of packed words
    (csrc/int4_matmul.cu nib_bf16x2): exponent of 128 over each biased
    nibble, then a bf16x2 FMA r * 1 - 136 (exact, so done in float32)."""
    x = words ^ 0x88888888
    r = _byte_perm(x, x >> 4, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12))
    r = (r & 0x000F000F) | 0x43004300
    halves = torch.stack([r & 0xFFFF, r >> 16]).to(torch.int32)
    as_bf16 = torch.where(halves >= 1 << 15, halves - (1 << 16), halves).to(torch.int16)
    return as_bf16.view(torch.bfloat16).float() - 136.0  # [lo (K row 2r), hi (2r+1)]


def _unpack_gemv(words: torch.Tensor, j: int):
    """The GEMV's unpack of byte j of packed words (csrc/int4_matmul.cu
    unpack_word, nib): the biased nibble in the mantissa of 2^23, minus 2^23 + 8."""
    out = []
    for sh in (0, 4):
        biased = ((words >> sh) & 0x0F0F0F0F) ^ 0x08080808
        bits = _byte_perm(biased, torch.full_like(words, 0x4B000000), 0x7540 | j)
        out.append(torch.from_numpy(bits.numpy().astype(np.uint32).view(np.float32)) - 8388616.0)
    return torch.stack(out)


@pytest.mark.parametrize("unpack", [_unpack_tensor_core, _unpack_gemv])
def test_kernel_nibble_unpack_matches_unpack_int4(unpack):
    """Every byte value, both nibbles: the kernels' bit tricks (emulated with
    torch integer ops) give unpack_int4's values exactly."""
    packed = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)[None]  # [1, 256]
    b = packed.to(torch.int64) & 0xFF
    words = b[:, 0::4] | b[:, 1::4] << 8 | b[:, 2::4] << 16 | b[:, 3::4] << 24  # [1, 64]
    got = torch.empty(2, 256)
    for j in range(4):
        got[:, j::4] = unpack(words, j)[:, 0]
    want = i4.unpack_int4(packed).float()  # [2, 256]: lo nibbles, hi nibbles
    assert torch.equal(got, want)


def test_int4_matmul_rejects_bad_shapes():
    with pytest.raises(ValueError):
        i4.int4_matmul(torch.zeros(2, 6), torch.zeros(4, 8, dtype=torch.int8),
                       torch.ones(1, 8))
    with pytest.raises(ValueError):
        i4.int4_matmul(torch.zeros(2, 8), torch.zeros(4, 8, dtype=torch.int8),
                       torch.ones(1, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 64, 8), (3, 256, 132), (8, 512, 520), (9, 64, 4),
                                   (70, 256, 196)])
def test_int4_kernel_matches_plain(cuda, dtype, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8, device=cuda)
    s = torch.rand((1, n), generator=g, device=cuda) + 0.5
    before = i4.launches
    got = i4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert i4.launches == before + 1 and got.dtype == dtype and got.shape == (m, n)
    want = i4.int4_matmul_plain(x, q4, s).float()
    # float32: only the order of the sums differs; bfloat16: one output rounding
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() <= tol


def _row_rel(got, want) -> float:
    """max over output rows of max |got - want| / the row's max |want|"""
    diff = (got.float() - want.float()).abs().amax(-1)
    return (diff / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


# per output row: float32 differs by the order of the sums; bf16 may flip
# one rounding of the output, at most one ulp, 2^-7 of the value
ROW_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k2,n", [(100, 196), (203, 1028), (2048, 4100), (517, 4096)])
@pytest.mark.parametrize("m", [9, 70, 200, 384, 1000])
def test_int4_gemm_rows_match_plain_at_ragged_shapes(cuda, m, k2, n, dtype):
    """M > 8 (the tensor-core GEMM in bf16, the FMA GEMM in float32) at
    ragged K2 (not a multiple of the 32-row stage; odd, so rows of x are
    not 16-byte aligned) and N (4 mod 8), and at whole tiles: every output
    row within ROW_REL of its largest, the same bits on two runs."""
    g = torch.Generator(device=cuda).manual_seed(m + k2 + n)
    x = torch.randn((m, 2 * k2), generator=g, device=cuda).to(dtype)
    q4 = torch.randint(-128, 128, (k2, n), generator=g, dtype=torch.int8, device=cuda)
    s = torch.rand((1, n), generator=g, device=cuda) * 0.02 + 0.01
    got, again = i4.int4_matmul(x, q4, s), i4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _row_rel(got, i4.int4_matmul_plain(x, q4, s)) <= ROW_REL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k2,n", [(1, 2048, 4096), (1, 5504, 4100), (3, 2048, 11008),
                                    (8, 2048, 1028)])
def test_int4_gemv_split_rows_match_plain(cuda, m, k2, n, dtype):
    """The decode GEMV with its rows split over blocks (a second pass adds
    the splits in a fixed order), 16-byte and 4-byte loads."""
    assert i4._splits(m, k2, n, dtype) > 1
    g = torch.Generator(device=cuda).manual_seed(m * k2 + n)
    x = torch.randn((m, 2 * k2), generator=g, device=cuda).to(dtype)
    q4 = torch.randint(-128, 128, (k2, n), generator=g, dtype=torch.int8, device=cuda)
    s = torch.rand((1, n), generator=g, device=cuda) * 0.02 + 0.01
    got, again = i4.int4_matmul(x, q4, s), i4.int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _row_rel(got, i4.int4_matmul_plain(x, q4, s)) <= ROW_REL[dtype]


@pytest.mark.cuda
def test_int4_kernel_rejects_unaligned_n(cuda):
    with pytest.raises(ValueError, match="multiple of 4"):
        i4.int4_matmul(torch.zeros(2, 8, device=cuda),
                       torch.zeros(4, 6, dtype=torch.int8, device=cuda),
                       torch.ones(1, 6, device=cuda))


def test_int4_matmul_never_falls_back_off_cpu():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (meta tensors stand in for a non-CPU device)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        i4.int4_matmul(torch.zeros(2, 8, device=meta),
                       torch.zeros(4, 8, dtype=torch.int8, device=meta),
                       torch.ones(1, 8, device=meta))


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    from vitron_tpu_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'csrc/x.cu(1): error: boom' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.library_path()
    assert not list((tmp_path / "build").rglob("*.so"))
