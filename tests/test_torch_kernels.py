"""The port's kernel modules (decode attention, flash attention, the
bottleneck pair, the selective scan), held against the reference.

On the CPU each wrapper (``repro_torch.kernels.*.ops``) takes its plain
PyTorch version; these tests hold that version against the JAX plain
reference and against the Pallas kernel in interpret mode, and check the
wrappers' dispatch and validation. The CUDA kernels themselves are held
against their plain versions on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bottleneck import ops as jbops
from repro.kernels.bottleneck import ref as jbref
from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro.kernels.flash_attention import ops as jfops
from repro.kernels.flash_attention import ref as jfref
from repro.kernels.ssm_scan import ops as jsops
from repro.kernels.ssm_scan import ref as jsref
from repro_torch.kernels.bottleneck import ops as bops
from repro_torch.kernels.bottleneck import ref as bref
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.kernels.ssm_scan import ref as sref

torch.set_num_threads(1)

NEG_INF = -1e30
# fp32: the two frameworks sum in different orders (tests/test_kernels.py)
FP32 = dict(rtol=1e-4, atol=2e-5)
# bf16 inputs and output: one bf16 rounding of the result dominates
BF16 = dict(rtol=5e-2, atol=5e-2)


def _inputs(B, H, K, hd, W, seed=0, lens=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(B, W, K, hd).astype(np.float32)
    v = rng.randn(B, W, K, hd).astype(np.float32)
    # slot-validity mask: ragged per-row lengths (ring-buffer semantics)
    if lens is None:
        lens = np.linspace(W // 2, W, B).astype(int)
    bias = np.zeros((B, W), np.float32)
    for i, n in enumerate(lens):
        bias[i, n:] = NEG_INF
    return q, k, v, bias


def _torch(*arrs, dtype=torch.float32):
    q, k, v, bias = (torch.from_numpy(a) for a in arrs)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias


def _jax(*arrs, dtype=jnp.float32):
    q, k, v, bias = (jnp.asarray(a) for a in arrs)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype), bias


@pytest.mark.parametrize("B,H,K,hd,W", [(2, 4, 2, 64, 128), (1, 8, 8, 32, 200),
                                        (2, 8, 1, 128, 96), (4, 4, 4, 64, 512)])
def test_plain_matches_reference_and_pallas_fp32(B, H, K, hd, W):
    arrs = _inputs(B, H, K, hd, W)
    out = ref.decode_attention_ref(*_torch(*arrs)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jref.decode_attention_ref(*_jax(*arrs))), **FP32)
    pallas = jops.decode_attention(*_jax(*arrs), block_k=64)
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


def test_plain_matches_reference_bf16():
    arrs = _inputs(2, 4, 2, 64, 128, seed=1)
    out = ref.decode_attention_ref(*_torch(*arrs, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    want = jref.decode_attention_ref(*_jax(*arrs, dtype=jnp.bfloat16))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_idle_row_beside_live_row_is_finite_and_matches():
    """A fully masked (idle) row must come out finite — with the finite
    NEG_INF that is the mean of v — and leave the live row untouched."""
    arrs = _inputs(2, 4, 2, 64, 128, seed=2, lens=[0, 128])
    out = ref.decode_attention_ref(*_torch(*arrs)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(
        out, np.asarray(jref.decode_attention_ref(*_jax(*arrs))), **FP32)
    np.testing.assert_allclose(
        out, np.asarray(jops.decode_attention(*_jax(*arrs), block_k=64)),
        **FP32)
    v = arrs[2]
    mean_v = np.repeat(v[0].mean(axis=0), 2, axis=0)      # (H, hd), G = 2
    np.testing.assert_allclose(out[0], mean_v, **FP32)


def test_cpu_tensors_take_the_plain_version_without_counting():
    t = _torch(*_inputs(2, 4, 2, 64, 96, seed=3))
    before = ops.launches
    out = ops.decode_attention(*t)
    assert ops.launches == before
    assert torch.equal(out, ref.decode_attention_ref(*t))


def test_non_cpu_non_cuda_and_mixed_devices_raise():
    q, k, v, bias = _torch(*_inputs(1, 2, 2, 32, 16))
    meta = [x.to("meta") for x in (q, k, v, bias)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.decode_attention(*meta)
    with pytest.raises(ValueError, match="different devices"):
        ops.decode_attention(meta[0], k, v, bias)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "bias", "strides",
                                 "groups"])
def test_kernel_argument_checks_raise(bad):
    """What the CUDA path refuses before it launches (checked on CPU
    tensors through the same validator)."""
    hd = 48 if bad == "head_dim" else 64
    q, k, v, bias = _torch(*_inputs(2, 4 if bad != "groups" else 3, 2, hd,
                                    32))
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    if bad == "bias":
        bias = bias[:, :-1]
    if bad == "strides":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        ops._check(q, k, v, bias)


# ---------------------------------------------------------------------------
# paged_decode_attention: the shared page pool, addressed by page tables
# ---------------------------------------------------------------------------

PAGED_SHAPES = [(2, 4, 2, 64, 9, 16, 3), (1, 8, 8, 32, 5, 8, 4),
                (3, 4, 1, 128, 12, 32, 2)]     # tests/test_kernels.py


def _paged_inputs(B, H, K, hd, P, page, n, seed=0, lens=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    pt = rng.randint(0, P, (B, n)).astype(np.int32)
    if lens is None:
        lens = np.linspace(page, n * page, B).astype(int)
    bias = np.zeros((B, n * page), np.float32)
    for i, L in enumerate(lens):
        bias[i, L:] = NEG_INF
    return q, kp, vp, pt, bias


def _paged_torch(q, kp, vp, pt, bias):
    return (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(pt), torch.from_numpy(bias))


def _paged_jax(q, kp, vp, pt, bias):
    return (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(bias))


@pytest.mark.parametrize("B,H,K,hd,P,page,n", PAGED_SHAPES)
def test_paged_plain_matches_reference_and_pallas_fp32(B, H, K, hd, P, page,
                                                       n):
    arrs = _paged_inputs(B, H, K, hd, P, page, n)
    out = ref.paged_decode_attention_ref(*_paged_torch(*arrs)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jref.paged_decode_attention_ref(*_paged_jax(*arrs))),
        **FP32)
    pallas = jops.paged_decode_attention(*_paged_jax(*arrs))
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


def test_paged_equals_contiguous_on_a_ring_layout():
    """A page table that lays row b's pages out in order over a pool cut
    from a contiguous cache gives the contiguous kernel's answer."""
    B, H, K, hd, page, n = 2, 4, 2, 64, 16, 4
    q, k, v, bias = _inputs(B, H, K, hd, n * page, seed=4)
    # pool page b*n + j holds slots [j*page, (j+1)*page) of row b
    kp = k.reshape(B * n, page, K, hd)
    vp = v.reshape(B * n, page, K, hd)
    pt = np.arange(B * n, dtype=np.int32).reshape(B, n)
    paged = ref.paged_decode_attention_ref(
        *_paged_torch(q, kp, vp, pt, bias))
    np.testing.assert_allclose(paged.numpy(),
                               ref.decode_attention_ref(
                                   *_torch(q, k, v, bias)).numpy(), **FP32)
    np.testing.assert_allclose(
        paged.numpy(), np.asarray(jops.paged_decode_attention(
            *_paged_jax(q, kp, vp, pt, bias))), **FP32)


def test_paged_idle_row_beside_live_row_is_finite():
    """An idle row (every entry on the trash page 0, every slot masked)
    beside a live row: finite, the mean of v over its slots, and the live
    row as the reference computes it."""
    B, H, K, hd, P, page, n = 2, 4, 2, 64, 6, 16, 3
    q, kp, vp, pt, bias = _paged_inputs(B, H, K, hd, P, page, n, seed=5,
                                        lens=[0, n * page])
    pt[0] = 0
    pt[1] = [1, 2, 3]
    out = ref.paged_decode_attention_ref(
        *_paged_torch(q, kp, vp, pt, bias)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(
        out, np.asarray(jref.paged_decode_attention_ref(
            *_paged_jax(q, kp, vp, pt, bias))), **FP32)
    mean_v = np.repeat(vp[0].mean(axis=0), 2, axis=0)    # (H, hd), G = 2
    np.testing.assert_allclose(out[0], mean_v, **FP32)


def test_paged_cpu_tensors_take_the_plain_version_without_counting():
    t = _paged_torch(*_paged_inputs(2, 4, 2, 64, 9, 16, 3, seed=6))
    before = (ops.launches, ops.paged_launches)
    out = ops.paged_decode_attention(*t)
    assert (ops.launches, ops.paged_launches) == before
    assert torch.equal(out, ref.paged_decode_attention_ref(*t))
    ops._check_paged(*t)              # what the CUDA path would accept
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.paged_decode_attention(*meta)
    with pytest.raises(ValueError, match="different devices"):
        ops.paged_decode_attention(meta[0], *t[1:])


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "table_dtype", "bias",
                                 "strides", "groups", "pages"])
def test_paged_kernel_argument_checks_raise(bad):
    """What the paged CUDA path refuses before it launches."""
    hd = 48 if bad == "head_dim" else 64
    n = ops.MAX_PAGES + 1 if bad == "pages" else 3
    q, kp, vp, pt, bias = _paged_torch(*_paged_inputs(
        2, 4 if bad != "groups" else 3, 2, hd, 9, 4, n, seed=7))
    if bad == "dtype":
        kp = kp.to(torch.bfloat16)
    if bad == "table_dtype":
        pt = pt.long()
    if bad == "bias":
        bias = bias[:, :-1]
    if bad == "strides":
        kp = kp.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        ops._check_paged(q, kp, vp, pt, bias)


def _offset_by_one(t):
    """``t``'s values in a buffer one element past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _slot_padded(t):
    """``t`` (A, S, K, hd) as a view whose slot stride is K*hd + 2
    elements: each slot's (K, hd) block stays contiguous, but slots do not
    keep 16-byte alignment."""
    A, S, K, hd = t.shape
    buf = torch.zeros(A, S, K * hd + 2, dtype=t.dtype)
    buf[..., :K * hd] = t.reshape(A, S, K * hd)
    return buf.as_strided(t.shape, (S * (K * hd + 2), K * hd + 2, hd, 1))


@pytest.mark.parametrize("bad", [None, "q_pointer", "k_pointer",
                                 "v_slot_stride", "pool_pointer",
                                 "pool_slot_stride", "verify_q_pointer"])
def test_bf16_rows_must_be_16_byte_aligned(bad):
    """What the bf16 split-K kernels' 16-byte row loads take, for the
    contiguous cache, the page pool and the verify step's (B,C,H,hd)
    chunk queries (checked on CPU tensors through the wrappers'
    validator): aligned tensors pass; a q, cache or pool whose data
    pointer or slot stride breaks 16-byte rows is refused."""
    q, k, v, bias = _torch(*_inputs(2, 4, 2, 64, 32, seed=8),
                           dtype=torch.bfloat16)
    _, kp, vp, pt, pbias = _paged_torch(*_paged_inputs(2, 4, 2, 64, 9, 4, 3,
                                                       seed=9))
    kp, vp = kp.bfloat16(), vp.bfloat16()
    vq, _, _, vpt, vbias = _paged_torch(*_verify_inputs(2, 3, 4, 2, 64, 9, 4,
                                                        3, seed=10))
    vq = vq.bfloat16()
    if bad == "verify_q_pointer":
        vq = _offset_by_one(vq)
    if bad == "q_pointer":
        q = _offset_by_one(q)
    if bad == "k_pointer":
        k = _offset_by_one(k)
    if bad == "v_slot_stride":
        v = _slot_padded(v)
    if bad == "pool_pointer":
        kp = _offset_by_one(kp)
    if bad == "pool_slot_stride":
        vp = _slot_padded(vp)
    # all pass the shape and layout checks; only the alignment differs
    ops._check(q, k, v, bias)
    ops._check_paged(q, kp, vp, pt, pbias)
    contiguous_bad = bad in ("q_pointer", "k_pointer", "v_slot_stride")
    paged_bad = bad in ("q_pointer", "pool_pointer", "pool_slot_stride")
    ops._check_paged(vq, kp, vp, vpt, vbias)
    verify_bad = bad in ("verify_q_pointer", "pool_pointer",
                         "pool_slot_stride")
    for (qq, kk, vv), refused in (((q, k, v), contiguous_bad),
                                  ((q, kp, vp), paged_bad),
                                  ((vq, kp, vp), verify_bad)):
        if refused:
            with pytest.raises(ValueError, match="16-byte aligned"):
                ops._check_rows_aligned(qq, kk, vv)
        else:
            ops._check_rows_aligned(qq, kk, vv)


# ---------------------------------------------------------------------------
# paged_verify_attention: C chunk queries per row against the page pool
# ---------------------------------------------------------------------------

VERIFY_SHAPES = [(2, 4, 4, 2, 64, 9, 16, 3), (1, 3, 8, 8, 32, 5, 8, 4),
                 (3, 2, 4, 1, 128, 12, 32, 2)]   # tests/test_kernels.py


def _verify_inputs(B, C, H, K, hd, P, page, n, seed=0):
    """Random pool and tables, and a per-query ragged validity bias, as
    the reference's kernel test makes them."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, C, H, hd).astype(np.float32)
    kp = rng.randn(P, page, K, hd).astype(np.float32)
    vp = rng.randn(P, page, K, hd).astype(np.float32)
    pt = rng.randint(0, P, (B, n)).astype(np.int32)
    lens = rng.randint(1, n * page + 1, (B, C))
    bias = np.where(np.arange(n * page)[None, None] < lens[..., None], 0.0,
                    NEG_INF).astype(np.float32)
    return q, kp, vp, pt, bias


@pytest.mark.parametrize("B,C,H,K,hd,P,page,n", VERIFY_SHAPES)
def test_verify_plain_matches_reference_and_pallas_fp32(B, C, H, K, hd, P,
                                                        page, n):
    arrs = _verify_inputs(B, C, H, K, hd, P, page, n)
    out = ref.paged_verify_attention_ref(*_paged_torch(*arrs)).numpy()
    assert out.shape == (B, C, H, hd)
    np.testing.assert_allclose(
        out, np.asarray(jref.paged_verify_attention_ref(*_paged_jax(*arrs))),
        **FP32)
    pallas = jops.paged_verify_attention(*_paged_jax(*arrs))
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


def test_verify_idle_row_and_pad_queries_match_reference():
    """Row 0 idle (every entry on the trash page 0, every query masked)
    beside a live row whose chunk has two real entries and two pad
    queries (which attend the cache up to their own position): finite,
    the idle row the mean of v over its slots, and both rows as the
    Pallas kernel computes them."""
    B, C, H, K, hd, P, page, n = 2, 4, 4, 2, 64, 6, 16, 3
    q, kp, vp, pt, bias = _verify_inputs(B, C, H, K, hd, P, page, n, seed=8)
    pt[0] = 0
    pt[1] = [1, 2, 3]
    bias[0] = NEG_INF
    # live row: 30 cached slots, chunk at slots 30.. (causal within chunk)
    bias[1] = np.where(np.arange(n * page)[None] <= 30 + np.arange(C)[:, None],
                       0.0, NEG_INF)
    out = ref.paged_verify_attention_ref(*_paged_torch(q, kp, vp, pt,
                                                       bias)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(
        out, np.asarray(jops.paged_verify_attention(
            *_paged_jax(q, kp, vp, pt, bias))), **FP32)
    mean_v = np.repeat(vp[0].mean(axis=0), 2, axis=0)    # (H, hd), G = 2
    for c in range(C):
        np.testing.assert_allclose(out[0, c], mean_v, **FP32)


def test_verify_single_query_equals_paged_decode():
    """Column 0 of a C=1 verify call is the paged decode answer."""
    q, kp, vp, pt, bias = _verify_inputs(2, 1, 4, 2, 64, 9, 16, 3, seed=9)
    t = _paged_torch(q, kp, vp, pt, bias)
    out = ops.paged_verify_attention(*t)
    dec = ops.paged_decode_attention(t[0][:, 0], t[1], t[2], t[3],
                                     t[4][:, 0])
    np.testing.assert_allclose(out[:, 0].numpy(), dec.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_verify_cpu_tensors_take_the_plain_version_without_counting():
    t = _paged_torch(*_verify_inputs(2, 3, 4, 2, 64, 9, 16, 3, seed=10))
    before = (ops.launches, ops.paged_launches, ops.verify_launches)
    out = ops.paged_verify_attention(*t)
    assert (ops.launches, ops.paged_launches, ops.verify_launches) == before
    assert torch.equal(out, ref.paged_verify_attention_ref(*t))
    ops._check_paged(*t)              # what the CUDA path would accept
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.paged_verify_attention(*meta)


@pytest.mark.parametrize("bad", ["bias_shape", "bias_stride", "table_dtype",
                                 "dtype", "strides"])
def test_verify_kernel_argument_checks_raise(bad):
    """What the verify CUDA path refuses before it launches."""
    q, kp, vp, pt, bias = _paged_torch(*_verify_inputs(
        2, 3, 4, 2, 64, 9, 4, 3, seed=11))
    if bad == "bias_shape":
        bias = bias[:, :-1]
    if bad == "bias_stride":
        bias = bias.transpose(1, 2).contiguous().transpose(1, 2)
    if bad == "table_dtype":
        pt = pt.long()
    if bad == "dtype":
        vp = vp.to(torch.bfloat16)
    if bad == "strides":
        kp = kp.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        ops._check_paged(q, kp, vp, pt, bias)


# ---------------------------------------------------------------------------
# flash_attention: full-sequence GQA (the prefill's attention)
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(2, 128, 4, 2, 64), (1, 200, 4, 4, 32), (2, 64, 8, 2, 64),
                (1, 256, 4, 1, 128), (1, 96, 6, 3, 32)]  # tests/test_kernels.py


def _flash_inputs(B, S, H, K, hd, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, hd).astype(np.float32),
            rng.randn(B, S, K, hd).astype(np.float32),
            rng.randn(B, S, K, hd).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,K,hd", FLASH_SHAPES)
def test_flash_matches_reference_and_pallas_fp32(B, S, H, K, hd, causal):
    q, k, v = _flash_inputs(B, S, H, K, hd)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = fops.flash_attention(*t, causal=causal).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jfref.attention_ref(q, k, v, causal=causal)), **FP32)
    pallas = jfops.flash_attention(q, k, v, causal=causal, block_q=64,
                                   block_k=64)
    np.testing.assert_allclose(out, np.asarray(pallas), **FP32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,K,hd", FLASH_SHAPES)
def test_flash_matches_reference_bf16(B, S, H, K, hd, causal):
    q, k, v = _flash_inputs(B, S, H, K, hd, seed=1)
    out = fops.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)), causal=causal)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for want in (jfref.attention_ref(jq, jk, jv, causal=causal),
                 jfops.flash_attention(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32), **BF16)


def test_flash_reads_nothing_past_s():
    """q, k and v as views of buffers whose rows past S are NaN (strided
    over batch): the result is finite and that of the contiguous inputs."""
    B, S, H, K, hd, pad = 2, 40, 4, 2, 32, 9
    rng = np.random.RandomState(2)
    bufs = []
    for heads in (H, K, K):
        a = rng.randn(B, S + pad, heads, hd).astype(np.float32)
        a[:, S:] = np.nan
        bufs.append(torch.from_numpy(a)[:, :S])
    out = fops.flash_attention(*bufs, causal=True)
    assert torch.isfinite(out).all()
    fops._check(*bufs)                  # what the CUDA path would accept
    want = fops.flash_attention(*(b.contiguous() for b in bufs), causal=True)
    assert torch.equal(out, want)


def test_flash_cpu_tensors_take_the_plain_version_without_counting():
    t = [torch.from_numpy(a) for a in _flash_inputs(1, 24, 4, 2, 32, 3)]
    before = fops.flash_launches
    out = fops.flash_attention(*t, causal=True, block_q=8, block_k=16)
    assert fops.flash_launches == before
    assert torch.equal(out, fref.attention_ref(*t, causal=True))
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fops.flash_attention(*meta)
    with pytest.raises(ValueError, match="different devices"):
        fops.flash_attention(meta[0], *t[1:])


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "groups", "length",
                                 "strides"])
def test_flash_kernel_argument_checks_raise(bad):
    """What the flash CUDA path refuses before it launches."""
    hd = 48 if bad == "head_dim" else 32
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(
        1, 16, 3 if bad == "groups" else 4, 2, hd, seed=4))
    if bad == "dtype":
        v = v.to(torch.bfloat16)
    if bad == "length":
        k, v = k[:, :-1], v[:, :-1]
    if bad == "strides":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        fops._check(q, k, v)


# ---------------------------------------------------------------------------
# bottleneck_encode / bottleneck_decode: the split point's fused pair
# ---------------------------------------------------------------------------


def _codes_close(codes, want):
    """Codes within 1, on fewer than 1e-3 of entries, where summation order
    moves z / s across a .5 tie (tests/test_kernels.py)."""
    diff = np.abs(np.asarray(codes, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,r", [(128, 128, 32), (64, 256, 100),
                                   (100, 64, 16), (256, 1280, 638)])
def test_bottleneck_encode_matches_reference_and_pallas(T, d, r, dtype):
    rng = np.random.RandomState(5)
    x = rng.randn(T, d).astype(np.float32)
    w = (rng.randn(d, r) * 0.05).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    codes, scales = bops.bottleneck_encode(tx, tw)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert tuple(codes.shape) == (T, r) and tuple(scales.shape) == (T, 1)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    for want_c, want_s in (jbref.encode_ref(jx, jw),
                           jbops.bottleneck_encode(jx, jw)):
        np.testing.assert_allclose(scales.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-7)
        _codes_close(codes.numpy(), want_c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,r", [(128, 128, 32), (64, 256, 100)])
def test_bottleneck_decode_matches_reference_and_pallas(T, d, r, dtype):
    rng = np.random.RandomState(6)
    codes = rng.randint(-127, 128, (T, r)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (T, 1)).astype(np.float32)
    w = (rng.randn(r, d) * 0.05).astype(np.float32)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jw = jnp.asarray(w, getattr(jnp, dtype))
    out = bops.bottleneck_decode(torch.from_numpy(codes),
                                 torch.from_numpy(scales), tw)
    assert out.dtype == torch.float32 and tuple(out.shape) == (T, d)
    for want in (jbref.decode_ref(codes, scales, jw),
                 jbops.bottleneck_decode(codes, scales, jw)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    bf = bops.bottleneck_decode(torch.from_numpy(codes),
                                torch.from_numpy(scales), tw, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, out.to(torch.bfloat16))


def test_bottleneck_batched_shapes_match_reference():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 37, 64).astype(np.float32)
    w = (rng.randn(64, 16) * 0.1).astype(np.float32)
    wd = (rng.randn(16, 64) * 0.1).astype(np.float32)
    codes, scales = bops.bottleneck_encode(torch.from_numpy(x),
                                           torch.from_numpy(w))
    assert tuple(codes.shape) == (2, 37, 16)
    assert tuple(scales.shape) == (2, 37, 1)
    jc, js = jbops.bottleneck_encode(x, w)
    _codes_close(codes.numpy(), jc)
    np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-7)
    y = bops.bottleneck_decode(codes, scales, torch.from_numpy(wd))
    assert tuple(y.shape) == (2, 37, 64)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jbops.bottleneck_decode(
            codes.numpy(), scales.numpy(), wd)), rtol=1e-5, atol=1e-4)


def test_bottleneck_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(3, 10, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
    wd = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    before = (bops.encode_launches, bops.bottleneck_decode_launches)
    codes, scales = bops.bottleneck_encode(x, w)
    y = bops.bottleneck_decode(codes, scales, wd)
    assert (bops.encode_launches, bops.bottleneck_decode_launches) == before
    want_c, want_s = bref.encode_ref(x.reshape(-1, 32), w)
    assert torch.equal(codes.reshape(-1, 8), want_c)
    assert torch.equal(scales.reshape(-1, 1), want_s)
    assert torch.equal(y.reshape(-1, 32), bref.decode_ref(
        want_c, want_s, wd))
    with pytest.raises(ValueError, match="cuda or cpu"):
        bops.bottleneck_encode(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        bops.bottleneck_decode(codes, scales, wd.to("meta"))


# The CUDA kernels take their products on the tensor cores in bf16: a
# float32 weight split into hi + mid + lo (csrc/bottleneck_gemm.cuh). Their
# numerical argument, held here with plain torch on the split point's
# distributions (init_bottleneck's float32 LeCun weights, a bf16 boundary
# activation; the encode at a reduced token count).


def _bf16_parts(w):
    """hi = rn(w), mid = rn(w - hi), lo = rn(w - hi - mid), as float32."""
    hi = w.to(torch.bfloat16).float()
    mid = (w - hi).to(torch.bfloat16).float()
    lo = (w - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _split_weight(rows, cols, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(rows, cols) / np.sqrt(rows))
                            .astype(np.float32))


@pytest.mark.parametrize("rows,cols", [(1280, 1278), (1278, 1280)])
def test_bf16_parts_rebuild_float32_weights(rows, cols):
    w = _split_weight(rows, cols, 10)
    hi, mid, lo = _bf16_parts(w)
    for part in (hi, mid, lo):
        assert torch.equal(part, part.to(torch.bfloat16).float())
    err = ((hi.double() + mid.double() + lo.double()) - w.double()).abs()
    assert float((err / w.double().abs()).max()) <= 2.0 ** -24


@pytest.mark.parametrize("r", [1278, 510, 254])
def test_three_product_encode_codes_match_plain(r):
    """x . hi + x . mid + x . lo, each product of bf16 values exact in
    float32 and summed in float32, gives the plain version's scales and its
    codes within 1 on fewer than 1e-3 of entries."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(256, 1280).astype(np.float32)).to(
        torch.bfloat16)
    w = _split_weight(1280, r, 12)
    want_c, want_s = bref.encode_ref(x, w)
    xf = x.float()
    z = sum(xf @ part for part in reversed(_bf16_parts(w)))
    s = torch.amax(torch.abs(z), dim=-1, keepdim=True) / 127.0 + 1e-8
    codes = torch.clamp(torch.round(z / s), -127, 127).to(torch.int8)
    np.testing.assert_allclose(s.numpy(), want_s.numpy(), rtol=1e-5,
                               atol=1e-7)
    _codes_close(codes.numpy(), want_c.numpy())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_decode_with_the_scale_taken_out_stays_within_tolerance(out_dtype):
    """scale * (codes . (hi + mid + lo)), the codes exact in bf16, against
    the plain (codes * scale) . w within chip_smoke.py's DECODE_TOL."""
    rng = np.random.RandomState(13)
    codes = torch.from_numpy(rng.randint(-127, 128, (256, 1278))
                             .astype(np.int8))
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, (256, 1))
                              .astype(np.float32))
    w = _split_weight(1278, 1280, 14)
    want = bref.decode_ref(codes, scales, w, out_dtype)
    cf = codes.float()
    y = (sum(cf @ part for part in reversed(_bf16_parts(w))) * scales
         ).to(out_dtype)
    tol = {torch.float32: dict(rtol=1e-5, atol=1e-4),
           torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}[out_dtype]
    np.testing.assert_allclose(y.float().numpy(), want.float().numpy(),
                               **tol)


@pytest.mark.parametrize("bad", ["w_shape", "x_dtype", "x_stride",
                                 "w_stride", "rank", "codes_dtype",
                                 "scales_rows",
                                 "out_dtype", "codes_stride"])
def test_bottleneck_kernel_argument_checks_raise(bad):
    """What the bottleneck CUDA paths refuse before they launch."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(12, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
    codes = torch.from_numpy(rng.randint(-127, 128, (12, 8)).astype(np.int8))
    scales = torch.ones(12, 1)
    wd = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    out_dtype = torch.float32
    if bad in ("w_shape", "x_dtype", "x_stride", "w_stride", "rank"):
        if bad == "w_shape":
            w = w[:-1]
        if bad == "x_dtype":
            x = x.to(torch.float16)
        if bad == "x_stride":
            x = x.t().contiguous().t()
        if bad == "w_stride":
            w = w.t().contiguous().t()
        if bad == "rank":
            w = torch.zeros(32, bops.MAX_RANK + 1)
        with pytest.raises(ValueError):
            bops._check_encode(x, w)
        return
    if bad == "codes_dtype":
        codes = codes.to(torch.int16)
    if bad == "scales_rows":
        scales = scales[:-1]
    if bad == "out_dtype":
        out_dtype = torch.float16
    if bad == "codes_stride":
        codes = codes.t().contiguous().t()
    with pytest.raises(ValueError):
        bops._check_decode(codes, scales, wd, out_dtype)


# ---------------------------------------------------------------------------
# ssm_scan: the Mamba blocks' selective scan
# ---------------------------------------------------------------------------


# the reference's oracle, jitted: its associative scan dispatches op by op
# (slowly) when eager
_jscan_ref = jax.jit(jsref.scan_ref)


def _scan_inputs(shape, seed, lo=0.5, hi=1.0, drive_scale=0.1):
    rng = np.random.RandomState(seed)
    decay = rng.uniform(lo, hi, shape).astype(np.float32)
    drive = (rng.randn(*shape) * drive_scale).astype(np.float32)
    return decay, drive


@pytest.mark.parametrize("B,S,C,N", [(2, 64, 128, 16), (1, 100, 60, 8),
                                     (2, 128, 256, 4), (1, 33, 16, 16)])
def test_scan_matches_reference_and_pallas(B, S, C, N):
    """The reference test's four shapes (tests/test_kernels.py), rtol 1e-5
    and atol 1e-6 against the associative-scan oracle and the Pallas
    kernel in interpret mode."""
    decay, drive = _scan_inputs((B, S, C, N), seed=10)
    td, tx = torch.from_numpy(decay), torch.from_numpy(drive)
    for h in (sref.scan_ref(td, tx), sops.chunked_scan(td, tx)):
        assert h.dtype == torch.float32 and tuple(h.shape) == (B, S, C, N)
        for want in (_jscan_ref(decay, drive),
                     jsops.chunked_scan(decay, drive, chunk=32, block_c=64)):
            np.testing.assert_allclose(h.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_scan_long_decay_matches_reference():
    """512 decays in [0.9, 0.999] and unit drive (the reference's
    long-sequence case): products stay finite, within 2e-4."""
    decay, drive = _scan_inputs((1, 512, 32, 8), seed=11, lo=0.9, hi=0.999,
                                drive_scale=1.0)
    h = sops.chunked_scan(torch.from_numpy(decay), torch.from_numpy(drive))
    assert torch.isfinite(h).all()
    for want in (_jscan_ref(decay, drive),
                 jsops.chunked_scan(decay, drive, chunk=64, block_c=32)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_scan_bf16_inputs_match_reference():
    """bf16 decay and drive are widened to float32 exactly, and the scan
    runs in float32 as the reference's does."""
    decay, drive = _scan_inputs((2, 40, 24, 16), seed=12)
    td = torch.from_numpy(decay).to(torch.bfloat16)
    tx = torch.from_numpy(drive).to(torch.bfloat16)
    h = sops.chunked_scan(td, tx)
    assert h.dtype == torch.float32
    assert torch.equal(h, sref.scan_ref(td.float(), tx.float()))
    jd = jnp.asarray(decay, jnp.bfloat16)
    jx = jnp.asarray(drive, jnp.bfloat16)
    np.testing.assert_allclose(h.numpy(), np.asarray(_jscan_ref(jd, jx)),
                               rtol=1e-5, atol=1e-6)


def test_scan_cpu_tensors_take_the_plain_version_without_counting():
    decay, drive = (torch.from_numpy(a) for a in _scan_inputs(
        (1, 9, 5, 3), seed=13))
    before = sops.scan_launches
    h = sops.chunked_scan(decay, drive, chunk=4, block_c=2)
    assert sops.scan_launches == before
    assert torch.equal(h, sref.scan_ref(decay, drive))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sops.chunked_scan(decay.to("meta"), drive.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        sops.chunked_scan(decay, drive.to("meta"))


@pytest.mark.parametrize("bad", ["rank", "shape", "dtype", "mixed_dtype",
                                 "strides", "empty"])
def test_scan_kernel_argument_checks_raise(bad):
    """What the scan CUDA path refuses before it launches."""
    decay, drive = (torch.from_numpy(a) for a in _scan_inputs(
        (2, 6, 4, 8), seed=14))
    if bad == "rank":
        decay, drive = decay[0], drive[0]
    if bad == "shape":
        drive = drive[:, :-1]
    if bad == "dtype":
        decay, drive = decay.half(), drive.half()
    if bad == "mixed_dtype":
        drive = drive.to(torch.bfloat16)
    if bad == "strides":
        decay = decay.transpose(2, 3).contiguous().transpose(2, 3)
    if bad == "empty":
        decay, drive = decay[:, :0], drive[:, :0]
    with pytest.raises(ValueError):
        sops._check(decay, drive)
    sops._check(*(torch.from_numpy(a) for a in _scan_inputs((2, 6, 4, 8),
                                                             seed=14)))
