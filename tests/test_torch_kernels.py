"""The port's decode-attention kernel module, held against the reference.

On the CPU the wrapper (``repro_torch.kernels.decode_attention.ops``) takes
the plain PyTorch version; these tests hold that version against the JAX
plain reference and against the Pallas kernel in interpret mode, and check
the wrapper's dispatch and validation. The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention import ref as jref
from repro_torch.kernels.decode_attention import ops, ref

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
