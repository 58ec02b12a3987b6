"""The port's flash attention against the JAX package's: the plain
PyTorch version (what a CPU tensor runs) vs ``attention_ref`` and vs the
Pallas kernel in interpret mode, over the JAX kernel tests' sweep (MHA,
GQA with a ragged S, MQA, S below a block) with the causal, non-causal,
``window=37`` and ``q_offset`` masks; Whisper's cross-attention shapes
(queries fewer than keys, no mask: 1, 32, 77 and 448 queries over 300
and 1500 frames, 16 heads of 64) vs ``blocked_attention`` and the
Pallas kernel; bf16; the zoo's ``blocked_attention`` vs JAX's; the wrapper's checks (TMA's layout
rules among them) and device route; and, on a card, the hand-written
CUDA kernels vs the plain version: fp32 on the CUDA-core kernel, bf16 on
the tensor-core one at its tile edges, every head dim, the serving
path's shape and full-width GQA (48/8) and MQA (48/1).

Tolerances against JAX are the JAX kernel tests': rtol 2e-4 / atol
2e-5 in fp32, 0.08 in bf16 (one bf16 rounding of the output, after sums
taken in another order). On a card the kernel and its plain version both
work in fp32 on the same bf16 inputs (the bf16 kernel's P.V on two bf16
halves of P, good to about 2^-17), so in bf16 they differ by one bf16
step of the output at most: rtol 1e-2 (above 2^-7), atol 1e-4. The JAX
package is imported inside the parity tests only, so that the ``cuda``
tests also run on a machine with a card and no jax: ``python -m pytest -q -m cuda tests/test_torch_attention.py``."""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.attention import kernel as flash_kernel
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.models import attention as tattn

RTOL, ATOL = 2e-4, 2e-5       # tests/test_kernels.py, fp32
BF16_TOL = 0.08               # tests/test_kernels.py, bf16
CARD_BF16_RTOL, CARD_BF16_ATOL = 1e-2, 1e-4   # kernel vs plain, bf16

# tests/test_kernels.py's flash sweep: (B, S, Hq, Hkv, D)
SHAPES = [(1, 128, 4, 4, 64),     # MHA, aligned
          (2, 200, 4, 2, 64),     # GQA, ragged seq
          (1, 300, 8, 1, 32),     # MQA
          (2, 64, 6, 2, 128)]     # tiny seq < block
MASKS = [dict(causal=True), dict(causal=False),
         dict(causal=True, window=37)]
_IDS = ["causal", "full", "window37"]
# Whisper-medium's cross-attention, non-causal: (B, Sq, Skv), 16 MHA
# heads of 64. A decode step's one query, the serving bursts' 32 and
# 448, and a ragged 77, over the 1500 frames and over 300
CROSS_SHAPES = [(2, 1, 1500), (2, 32, 1500), (2, 77, 300), (2, 448, 1500)]


def _qkv(B, S, Hq, Hkv, D, seed=0, sq=None):
    rng = np.random.default_rng(seed + B * 1000 + S * 10 + Hq + Hkv + D)
    f = np.float32
    return (rng.standard_normal((B, sq or S, Hq, D)).astype(f),
            rng.standard_normal((B, S, Hkv, D)).astype(f),
            rng.standard_normal((B, S, Hkv, D)).astype(f))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("kwargs", MASKS, ids=_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_jax_reference(shape, kwargs):
    import jax.numpy as jnp
    from repro.kernels.attention.ref import attention_ref as jref

    q, k, v = _qkv(*shape)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs)
    got = attention_ref(*_t(q, k, v), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kwargs", MASKS, ids=_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cpu_route_matches_pallas_kernel(shape, kwargs):
    """The wrapper on CPU tensors vs the TPU kernel (Pallas, interpret
    mode on the CPU, as tests/test_kernels.py runs it)."""
    import jax.numpy as jnp
    from repro.kernels.attention.ops import flash_attention as jflash

    q, k, v = _qkv(*shape, seed=1)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs)
    got = flash_attention(*_t(q, k, v), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_q_offset_matches_jax(shape, window):
    """The last Sq / 2 queries of a sequence at ``q_offset`` (a chunked
    prefill) vs the reference and the Pallas kernel."""
    import jax.numpy as jnp
    from repro.kernels.attention.ops import flash_attention as jflash
    from repro.kernels.attention.ref import attention_ref as jref

    B, S, Hq, Hkv, D = shape
    sq = S // 2
    q, k, v = _qkv(*shape, seed=2, sq=sq)
    kw = dict(causal=True, window=window, q_offset=S - sq)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    got = flash_attention(*_t(q, k, v), **kw).numpy()
    for want in (jref(jq, jk, jv, **kw), jflash(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def _cross_qkv(B, Sq, Skv, seed):
    rng = np.random.default_rng(seed + Sq * 10 + Skv)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, 16, 64), (B, Skv, 16, 64),
                           (B, Skv, 16, 64)))


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=str)
def test_cross_attention_shapes_match_jax(shape):
    """Fewer queries than keys without a mask, as Whisper's
    cross-attention runs it (every query sees every frame), on the CPU
    route vs the JAX package's ``blocked_attention`` at its default
    blocks (queries padded to 512, keys to 1024) and vs the Pallas kernel
    in interpret mode (both padded to 128 and masked by kv_valid)."""
    import jax.numpy as jnp
    from repro.kernels.attention.ops import flash_attention as jflash
    from repro.models import attention as jattn

    q, k, v = _cross_qkv(*shape, seed=17)
    got = tattn.blocked_attention(*_t(q, k, v), causal=False)
    assert got.shape == q.shape
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (jattn.blocked_attention(jq, jk, jv, causal=False),
                 jflash(jq, jk, jv, causal=False)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_bf16_matches_jax():
    import jax.numpy as jnp
    from repro.kernels.attention.ops import flash_attention as jflash
    from repro.kernels.attention.ref import attention_ref as jref

    q, k, v = _qkv(1, 128, 2, 2, 64, seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    for want in (jref(jq, jk, jv, causal=True),
                 jflash(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(
            got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)), rtol=BF16_TOL,
            atol=BF16_TOL)


def test_kv_valid_masks_the_keys_past_it():
    q, k, v = _t(*_qkv(2, 96, 4, 2, 32, seed=4))
    got = flash_attention(q, k, v, causal=False, kv_valid=50)
    want = attention_ref(q, k[:, :50], v[:, :50], causal=False)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kwargs", [dict(causal=True),
                                    dict(causal=True, window=37),
                                    dict(causal=True, q_offset=40)],
                         ids=["causal", "window37", "q_offset40"])
def test_blocked_attention_matches_jax(kwargs):
    """The zoo's attention (the routed kernel here, the pure-JAX online
    softmax there, at small blocks so it walks several) and the naive
    oracles of both packages."""
    import jax.numpy as jnp
    from repro.models import attention as jattn

    q, k, v = _qkv(2, 160, 4, 2, 64, seed=5)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    got = tattn.blocked_attention(*_t(q, k, v), **kwargs).numpy()
    blocked = jattn.blocked_attention(jq, jk, jv, q_block=64, kv_block=64,
                                      **kwargs)
    np.testing.assert_allclose(got, np.asarray(blocked), rtol=RTOL,
                               atol=ATOL)
    naive = attention_ref(*_t(q, k, v), **kwargs).numpy()
    np.testing.assert_allclose(
        naive, np.asarray(jattn.reference_attention(jq, jk, jv, **kwargs)),
        rtol=RTOL, atol=ATOL)


def test_cpu_route_runs_the_plain_version_and_launches_nothing(monkeypatch):
    q, k, v = _t(*_qkv(1, 40, 4, 2, 32, seed=6))
    calls = []
    monkeypatch.setattr(flash_kernel, "flash_attention_cuda",
                        lambda *a, **kw: calls.append(a))
    before = flash_kernel.FLASH_LAUNCHES.total
    got = dispatch.flash_attention(q, k, v, causal=True, window=9)
    assert not calls and flash_kernel.FLASH_LAUNCHES.total == before
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=True,
                                                  window=9))
    assert dispatch.impl_for(q.device) == "torch"


def test_wrapper_rejects_bad_arguments():
    q, k, v = _t(*_qkv(1, 16, 4, 2, 32, seed=7))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash_attention(q, k[:, :, :1].expand(1, 16, 3, 32), v, causal=True)
    with pytest.raises(ValueError, match=r"\[B, Sq, Hq, D\]"):
        flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="kv_valid"):
        flash_attention(q, k, v, kv_valid=17)
    with pytest.raises(ValueError, match="kv_valid"):
        flash_attention(q, k, v, kv_valid=0)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.to("meta"), v)


@pytest.mark.parametrize("kwargs", [
    dict(causal=False, window=5, q_offset=100),
    dict(causal=False, window=5, q_offset=4, kv_valid=10),
    dict(causal=True, window=3, q_offset=2, kv_valid=2)],
    ids=["past_keys", "past_kv_valid", "causal_past_kv_valid"])
def test_wrapper_rejects_a_window_that_leaves_a_row_no_key(kwargs):
    """A row whose window lies past the last valid key has no softmax
    (the kernel would write 0, the plain version a mean of v), so the
    wrapper refuses it on every device."""
    q, k, v = _t(*_qkv(1, 16, 4, 2, 32, seed=8))
    with pytest.raises(ValueError, match="no key"):
        flash_attention(q, k, v, **kwargs)


def test_window_edge_row_sees_the_last_valid_key():
    """At the edge the wrapper accepts, the last row's window holds
    exactly the last valid key, so its output is that key's value."""
    q, k, v = _t(*_qkv(1, 16, 4, 2, 32, seed=9))
    out = flash_attention(q[:, :4], k, v, causal=False, window=5,
                          q_offset=10, kv_valid=10)
    torch.testing.assert_close(out[:, -1], v[:, 9].repeat_interleave(2, 1),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ on a card --

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", MASKS + [dict(causal=True, q_offset=29)],
                         ids=_IDS + ["q_offset29"])
@pytest.mark.parametrize("shape", SHAPES + [(2, 77, 4, 4, 80)], ids=str)
def test_cuda_kernel_matches_plain_version(shape, kwargs, dtype):
    _card()
    dt = getattr(torch, dtype)
    q, k, v = (t.cuda().to(dt) for t in _t(*_qkv(*shape, seed=8)))
    before = flash_kernel.FLASH_LAUNCHES.total
    got = flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert flash_kernel.FLASH_LAUNCHES.total == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = attention_ref(q, k, v, **kwargs)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" \
        else dict(rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", [((2, 300, 32, 8, 128), 64),
                                          ((2, 300, 64, 4, 128), None)],
                         ids=["gqa32/8-window64", "gqa64/4"])
def test_cuda_bf16_kernel_at_the_moe_familys_heads(shape, window):
    """The bf16 kernel at Mixtral's GQA 32/8 with a sliding window and at
    Qwen3-MoE's 64/4 (16 query heads a KV head), causal, against its
    plain version."""
    _card()
    q, k, v = (t.cuda().to(torch.bfloat16)
               for t in _t(*_qkv(*shape, seed=12)))
    before = flash_kernel.FLASH_LAUNCHES.total
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_kernel.FLASH_LAUNCHES.total == before + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)


def test_tma_checks_refuse_a_misaligned_base_or_stride():
    """The CUDA driver holds TMA's 16-byte rules when the entry point
    encodes a bf16 operand's tensor map; the entry point then returns that
    operand's refusal code, which the binding raises as a ValueError
    naming the operand and its layout. Held here on CPU tensors of the
    layouts the card refuses: a view one element past a 16-byte boundary,
    and a head stride of 33 bf16 (66 bytes). 0 raises nothing, a CUDA
    error a RuntimeError."""
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(1, 16, 4, 2, 32,
                                                       seed=14)))
    base = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + q.numel()].view(q.shape)
    wide = torch.zeros(1, 16, 2, 33, dtype=torch.bfloat16)[..., :32]
    flash_kernel.raise_for(0, q, k, v)
    assert base.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="cannot read q: .* starts 2 bytes "
                                         "past a 16-byte boundary"):
        flash_kernel.raise_for(-1, shifted, k, v)
    with pytest.raises(ValueError, match=r"cannot read k: .* strides are "
                                         r"\[2112, 132, 66\] bytes"):
        flash_kernel.raise_for(-2, q, wide, v)
    with pytest.raises(ValueError, match="cannot read v"):
        flash_kernel.raise_for(-3, q, k, wide)
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        flash_kernel.raise_for(1, q, k, v)


def test_tma_refusal_codes_match_the_entry_point():
    """The binding's refusal codes are the ones the CUDA source returns
    (its constants, read from the text: the source builds on a card
    only)."""
    src = (flash_kernel.SOURCES[1]).read_text()
    found = re.search(r"constexpr int kTmaRefusedQ = (-\d+), "
                      r"kTmaRefusedK = (-\d+), kTmaRefusedV = (-\d+);", src)
    assert found is not None
    assert dict(zip(map(int, found.groups()), "qkv")) \
        == flash_kernel.TMA_REFUSED
    assert all(f"return kTmaRefused{n};" in src for n in "QKV")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 96, 4, 4, 128), (8, 32, 20, 20, 128)],
                         ids=str)
def test_cuda_kernel_rows_do_not_depend_on_batch(shape):
    _card()
    q, k, v = (t.cuda().to(torch.bfloat16)
               for t in _t(*_qkv(*shape, seed=9)))
    full = flash_attention(q, k, v, causal=True)
    for b in range(8):
        one = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                              causal=True)
        assert torch.equal(one[0], full[b])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq", [1, 32, 77, 448])
@pytest.mark.parametrize("Skv", [300, 1500])
def test_cuda_kernel_at_the_cross_attention_shapes(Skv, Sq, dtype):
    """Whisper's cross-attention on the card: fewer queries than keys,
    no mask (every query tile visits every key tile, the last one
    ragged), the query tile larger than Sq at 1, 32 and 77; one launch,
    keyed as non-causal, against the plain version."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt)
               for a in _cross_qkv(2, Sq, Skv, seed=18))
    before = dict(flash_kernel.FLASH_LAUNCHES.by_shape)
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    key = flash_kernel.launch_key(2, Sq, Skv, 16, 16, 64, causal=False)
    assert flash_kernel.FLASH_LAUNCHES.by_shape[key] == before.get(key,
                                                                   0) + 1
    want = attention_ref(q, k, v, causal=False)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" \
        else dict(rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_cuda_cross_attention_rows_do_not_depend_on_batch():
    """At Whisper's burst-A cross-attention shape (8 x 32 queries over
    1500 frames, 16 heads of 64, non-causal): each row of the B = 8
    launch equals that row's B = 1 launch, bit for bit."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(19)
    q = torch.randn(8, 32, 16, 64, generator=g, device="cuda")
    k, v = (torch.randn(8, 1500, 16, 64, generator=g, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    full = flash_attention(q, k, v, causal=False)
    for b in range(8):
        one = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                              causal=False)
        assert torch.equal(one[0], full[b])


def test_launch_keys_carry_the_mask():
    """A causal launch keys by its shape, as the counter always did; a
    non-causal one appends ``NON_CAUSAL``."""
    assert flash_kernel.launch_key(8, 32, 32, 16, 16, 64) == \
        (8, 32, 32, 16, 16, 64)
    assert flash_kernel.launch_key(8, 1, 1500, 16, 16, 64, causal=False) \
        == (8, 1, 1500, 16, 16, 64, flash_kernel.NON_CAUSAL)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    _card()
    q, k, v = (t.cuda() for t in _t(*_qkv(1, 16, 4, 2, 32, seed=10)))
    before = flash_kernel.FLASH_LAUNCHES.total
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous last dim"):
        flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                        v)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q[..., :16], k[..., :16], v[..., :16])
    assert flash_kernel.FLASH_LAUNCHES.total == before


# the bf16 kernel's edges: 64 query rows a consumer warpgroup, 128 a block
# and 128 keys a K/V stage. (B, Sq, Skv, Hq, Hkv, q_offset): MHA, GQA and
# MQA, S of 1, 63, 64, 65, 127, 129 and 200, and a chunk of 100 queries
# at q_offset 160 over 260 keys
EDGE_SHAPES = [(1, 1, 1, 2, 1, 0), (2, 63, 63, 4, 4, 0), (1, 64, 64, 4, 2, 0),
               (2, 65, 65, 4, 1, 0), (1, 127, 127, 2, 2, 0),
               (1, 129, 129, 4, 2, 0), (2, 200, 200, 4, 2, 0),
               (2, 100, 260, 4, 2, 160)]
# each mask; window 5 is narrower than one K/V stage; kv_valid is Skv - 13
EDGE_MASKS = [dict(causal=True), dict(causal=False),
              dict(causal=True, window=37), dict(causal=True, window=5),
              dict(causal=False, kv_valid=-13)]
_EDGE_IDS = ["causal", "full", "window37", "window5", "kv_valid"]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("kwargs", EDGE_MASKS, ids=_EDGE_IDS)
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_cuda_bf16_kernel_at_tile_edges(shape, kwargs, D):
    _card()
    B, Sq, Skv, Hq, Hkv, q_offset = shape
    kw = dict(kwargs, q_offset=q_offset)
    if "kv_valid" in kw:
        kw["kv_valid"] = max(1, Skv + kw["kv_valid"])
    rng = np.random.default_rng(Sq * 1000 + Skv + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().to(torch.bfloat16)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = flash_kernel.FLASH_LAUNCHES.total
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.FLASH_LAUNCHES.total == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(),
                               attention_ref(q, k, v, **kw).float(),
                               rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)


@pytest.mark.cuda
def test_cuda_bf16_kernel_at_the_serving_paths_long_prompt():
    """Qwen1.5-4B's 2048-token flush: 4 x 2048 x 20 heads of 128, causal,
    against the plain version's 2048 x 2048 x 20 scores."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = (torch.randn(4, 2048, 20, 128, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv", [(8, 32, 48, 8), (4, 2048, 48, 8),
                                        (8, 32, 48, 1), (4, 2048, 48, 1)],
                         ids=["gqa-48-8-short", "gqa-48-8-long",
                              "mqa-48-1-short", "mqa-48-1-long"])
def test_cuda_bf16_kernel_at_full_width_gqa_and_mqa(B, S, Hq, Hkv):
    """Nemotron-4-15B's grouped attention (48 query heads over 8 KV
    heads) and Granite-20B's multi-query attention (48 over 1), heads of
    128, causal, at the serving bursts' two shapes: one launch each,
    against the plain version."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(S + Hkv)
    q = torch.randn(B, S, Hq, 128, generator=g, device="cuda")
    k, v = (torch.randn(B, S, Hkv, 128, generator=g, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    before = flash_kernel.FLASH_LAUNCHES.total
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_kernel.FLASH_LAUNCHES.total == before + 1
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=CARD_BF16_RTOL, atol=CARD_BF16_ATOL)


@pytest.mark.cuda
def test_cuda_bf16_kernel_refuses_what_tma_cannot_read():
    """A view at a 1-element offset (not 16-byte aligned) and a head
    stride of 66 bytes raise before any launch; the fp32 kernel takes
    both."""
    _card()
    q, k, v = (t.cuda() for t in _t(*_qkv(1, 16, 4, 2, 32, seed=16)))

    def layouts(dtype):
        """q at a 1-element offset, k with rows of 33 elements"""
        base = torch.zeros(q.numel() + 8, dtype=dtype, device="cuda")
        shifted = base[1:1 + q.numel()].view(q.shape)
        shifted.copy_(q)
        wide = torch.zeros(1, 16, 2, 33, dtype=dtype, device="cuda")
        wide[..., :32] = k
        return shifted, wide[..., :32], v.to(dtype)

    sq, sk, sv = layouts(torch.bfloat16)
    before = flash_kernel.FLASH_LAUNCHES.total
    with pytest.raises(ValueError, match="cannot read q: .* starts 2 bytes"):
        flash_attention(sq, sk.contiguous(), sv)
    with pytest.raises(ValueError, match="cannot read k: .* 66] bytes"):
        flash_attention(sq.clone(), sk, sv)
    assert flash_kernel.FLASH_LAUNCHES.total == before
    got = flash_attention(*layouts(torch.float32))
    assert flash_kernel.FLASH_LAUNCHES.total == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v), rtol=RTOL,
                               atol=ATOL)


def test_cpu_route_differentiates_like_jax():
    """The CPU route's gradient is autograd's of the plain version (the
    card's is the backward kernel's, ``tests/test_torch_attention_bwd.py``):
    d(sum of out * w)/d(q, k, v) against jax.grad of the reference's
    oracle."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.attention.ref import attention_ref as jref

    q, k, v = _qkv(1, 24, 4, 2, 32, seed=11)
    w = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    (flash_attention(tq, tk, tv, causal=True) * torch.from_numpy(w)).sum() \
        .backward()
    want = jax.grad(lambda a, b, c: jnp.sum(jref(a, b, c, causal=True) * w),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, g in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_gradients():
    """Where the backward kernel would not take the launch (q_offset,
    kv_valid short of the keys, a window without the causal mask) the
    wrapper refuses a gradient and launches nothing; under no_grad the
    same call runs; a gradient of a launch it takes goes through the
    forward (with its logsumexp) and the backward kernel, one launch
    each, as the CPU route's autograd gives it."""
    _card()
    q, k, v = (t.cuda() for t in _t(*_qkv(1, 16, 4, 2, 32, seed=13)))
    before = flash_kernel.FLASH_LAUNCHES.total
    for kwargs in (dict(causal=True, q_offset=2),
                   dict(causal=True, kv_valid=9),
                   dict(causal=False, window=4)):
        for leaf in range(3):
            args = [q, k, v]
            args[leaf] = args[leaf].clone().requires_grad_()
            with pytest.raises(ValueError, match="backward kernel takes"):
                flash_attention(*args, **kwargs)
    assert flash_kernel.FLASH_LAUNCHES.total == before
    with torch.no_grad():
        out = flash_attention(q.clone().requires_grad_(), k, v, causal=True,
                              q_offset=2)
    assert flash_kernel.FLASH_LAUNCHES.total == before + 1
    assert not out.requires_grad
    bwd = flash_kernel.FLASH_BWD_LAUNCHES.total
    gq = q.clone().requires_grad_()
    flash_attention(gq, k, v, causal=True).sum().backward()
    assert flash_kernel.FLASH_LAUNCHES.total == before + 2
    assert flash_kernel.FLASH_BWD_LAUNCHES.total == bwd + 1
    cq = q.cpu().requires_grad_()
    flash_attention(cq, k.cpu(), v.cpu(), causal=True).sum().backward()
    torch.testing.assert_close(gq.grad.cpu(), cq.grad, rtol=RTOL, atol=ATOL)
