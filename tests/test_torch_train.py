"""The port's generic training pieces held against the reference:
``optim`` (AdamW and SGD with the global-norm clip, the three
schedules), ``data/lm.py``, ``checkpoint/store.py`` and
``launch/train.py``; and the three repairs the training path needed:
``models/ssm.py:_selective_scan`` (no in-place write into a tensor autograd
saved), ``models/attention.py``'s tensor-core route under autograd
(``_MatmulF32``) and the kernel wrappers' refusal to run under grad
(``kernels/_build.py:device_of``).

Inputs come from numpy with a seed. The reference runs on the CPU, its
Pallas kernels in interpret mode.

Tolerances: float32 parameters and moments within rtol 1e-6 (and atol
1e-6 of the leaf's largest magnitude: a moment's running sum cancels in
some elements, and the clip scale's sum of squares runs in another
order), bf16
parameters within one bf16 step (2**-7 of their magnitude, rounded down
to a power of two); schedules within rtol 1e-6; data bit for bit; the
scan's gradients within rtol 1e-5; the tensor-core route's gradients
within 1e-6 of the upcast route's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.checkpoint import load_pytree as jload, save_pytree as jsave
from repro.data import lm as jlm
from repro.launch import train as jtrain
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.checkpoint import save_pytree as tsave
from repro_torch.data import lm as tlm
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t, np.float32) if t.dtype == jnp.bfloat16 \
        else np.asarray(t)


def _pairs(want, got, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in sorted(want):
            yield from _pairs(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(want) is type(got) and len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            yield from _pairs(w, g, f"{path}/{i}")
    else:
        yield path, want, got


# ---------------------------------------------------------------------------
# optim: schedules, AdamW, SGD
# ---------------------------------------------------------------------------


SCHEDULES = [("constant", (3e-4,)), ("linear_warmup", (1e-3, 7)),
             ("cosine_with_warmup", (1e-3, 4, 17)),
             ("cosine_with_warmup", (2e-2, 1, 1))]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_reference(name, args):
    """Each schedule at steps 0..20: a float32 0-d tensor on the step's
    device, within rtol 1e-6 of the reference."""
    want_fn = getattr(joptim, name)(*args)
    got_fn = getattr(toptim, name)(*args)
    for step in range(21):
        got = got_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want_fn(jnp.int32(step))), rtol=1e-6,
            err_msg=f"{name}{args} at step {step}")


def _tree(rng):
    """float32 and bf16 leaves in a dict with a nested list and tuple."""
    def f32(*shape):
        return rng.randn(*shape).astype(np.float32)
    return {"w": f32(4, 5),
            "stack": [f32(3).astype(jnp.bfloat16),
                      (f32(2, 2), f32(6).astype(jnp.bfloat16))],
            "unused": f32(7)}


def _grads(rng, tree, scale):
    """Gradients like ``tree`` times ``scale``; "unused" is zeros for the
    reference and ``None`` for the port (autograd's answer for a leaf the
    loss never read)."""
    want = jax.tree.map(lambda a: (rng.randn(*a.shape) * scale).astype(
        a.dtype), tree)
    want["unused"] = np.zeros_like(want["unused"])
    got = bridge.to_torch(want, "cpu")
    got["unused"] = None
    return want, got


def _bf16_step(x):
    """One bf16 step at |x|: 2**(floor(log2 |x|) - 7)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_tree_close(want, got, what):
    for path, w, g in _pairs(want, got):
        if g is None:
            continue
        w, gn = _np(w), _np(g)
        assert w.shape == gn.shape, path
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            assert (np.abs(gn - w) <= _bf16_step(w)).all(), \
                f"{what}{path}: more than one bf16 step off"
        else:
            np.testing.assert_allclose(
                gn, w, rtol=1e-6, atol=1e-6 * float(np.abs(w).max()),
                err_msg=f"{what}{path}")


OPTIMIZERS = [
    ("adamw", lambda m: m.adamw(m.cosine_with_warmup(1e-2, 2, 5))),
    ("adamw_const_wd", lambda m: m.adamw(3e-3, b1=0.8, b2=0.99,
                                         weight_decay=0.1, clip_norm=0.5)),
    ("sgd", lambda m: m.sgd(m.linear_warmup(5e-2, 3))),
    ("sgd_const", lambda m: m.sgd(1e-2, momentum=0.5)),
]


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("name,make", OPTIMIZERS, ids=[o[0] for o in
                                                       OPTIMIZERS])
def test_optimizer_apply_matches_reference(name, make, clip):
    """Three ``apply`` steps on identical trees (float32 and bf16 leaves,
    a nested list and tuple, a ``None`` gradient), with the global-norm
    clip active (gradient norm ~30) or inactive (~0.03): parameters and
    moments against the reference; the state's step an int32 0-d tensor;
    the arguments left untouched."""
    rng = np.random.RandomState(5)
    tree = _tree(rng)
    jopt, topt = make(joptim), make(toptim)
    jp, tp = tree, bridge.to_torch(tree, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    scale = 3.0 if clip == "active" else 3e-3
    for _ in range(3):
        jg, tg = _grads(rng, tree, scale)
        before = [t.clone() for _, _, t in _pairs(js["m"], ts["m"])]
        jp, js = jopt.apply(jp, js, jg)
        tp2, ts2 = topt.apply(tp, ts, tg)
        assert all(torch.equal(b, t) for b, (_, _, t) in
                   zip(before, _pairs(js["m"], ts["m"])))
        tp, ts = tp2, ts2
        _assert_tree_close(jp, tp, f"{name} params")
        for k in ("m", "v"):
            if k in js:
                _assert_tree_close(js[k], ts[k], f"{name} {k}")
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
        assert int(ts["step"]) == int(js["step"])
    for _, _, t in _pairs(js["m"], ts["m"]):
        assert t.dtype == torch.float32
    assert tp["stack"][1][1].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# data/lm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "hubert-xlarge",
                                  "qwen2-vl-2b"])
def test_lm_batches_equal_reference_bit_for_bit(arch):
    """Text (bigram coupling), audio (span masks) and vlm (M-RoPE triples):
    ``lm_batch`` and the first three ``lm_stream`` batches."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    for want, got in zip(
            [jlm.lm_batch(np.random.RandomState(4), jcfg, 3, 24)]
            + [next(s) for s in [jlm.lm_stream(9, jcfg, 2, 16)] * 3],
            [tlm.lm_batch(np.random.RandomState(4), tcfg, 3, 24)]
            + [next(s) for s in [tlm.lm_stream(9, tcfg, 2, 16)] * 3]):
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# checkpoint/store.py and launch/train.py
# ---------------------------------------------------------------------------


def _ckpt_tree(rng):
    return {"zeta": rng.randn(3, 2).astype(np.float32),
            "alpha": [rng.randn(4).astype(jnp.bfloat16),
                      (np.arange(5, dtype=np.int32),),
                      {"b": rng.randn(2, 2, 2).astype(jnp.bfloat16),
                       "a": np.int32(7)}],
            "mid": (rng.randn(1).astype(np.float32), [])}


def _files(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = f.read()
    with open(os.path.join(path, "structure.json")) as f:
        structure = f.read()
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, structure, arrays


def test_checkpoint_format_equals_reference_and_crosses(tmp_path):
    """bf16, float32 and int32 leaves in dicts, lists and tuples: the
    port's directory has the reference's manifest and structure text and
    equal arrays (bf16 as raw 2-byte records); each side reads the
    other's."""
    tree = _ckpt_tree(np.random.RandomState(2))
    jsave(str(tmp_path / "ref"), jax.tree.map(jnp.asarray, tree))
    tsave(str(tmp_path / "port"), bridge.to_torch(tree, "cpu"))
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        assert got[2][k].dtype == want[2][k].dtype, k
        assert got[2][k].tobytes() == want[2][k].tobytes(), k
    # the reference reads the port's directory, the bridge the reference's
    for path, w, g in _pairs(tree, jload(str(tmp_path / "port"))):
        assert g.tobytes() == np.asarray(w).tobytes(), path
    back = bridge.load_checkpoint(str(tmp_path / "ref"), "cpu")
    for path, w, g in _pairs(bridge.to_torch(tree, "cpu"), back):
        assert g.dtype == w.dtype and torch.equal(g, w), path


def test_train_arch_writes_the_reference_structure(tmp_path, capsys):
    """Reduced phi4-mini, two steps on the CPU: the port's ``train_arch``
    prints the reference's ``[train]`` lines and writes a directory with
    the reference's structure, shapes and dtypes."""
    arch = "phi4-mini-3.8b"
    jtrain.train_arch(arch, True, 2, 2, 16, 1e-3, str(tmp_path / "ref"))
    ref_out = capsys.readouterr().out
    ttrain.train_arch(arch, True, 2, 2, 16, 1e-3, str(tmp_path / "port"),
                      device="cpu")
    port_out = capsys.readouterr().out
    name = tconfigs.get_reduced(arch).name
    want, got = (_files(tmp_path / side / name) for side in ("ref", "port"))
    assert json.loads(got[0]) == json.loads(want[0])
    assert got[1] == want[1]
    for out in (ref_out, port_out):
        assert out.splitlines()[0].startswith(f"[train] {name}: 2L d=256")
    def shape(out, side):
        return [ln.replace(str(tmp_path / side), "OUT").split("loss=")[0]
                for ln in out.splitlines()]
    assert shape(port_out, "port") == shape(ref_out, "ref")
    loaded = bridge.load_checkpoint(str(tmp_path / "port" / name), "cpu")
    assert all(torch.isfinite(t).all() for _, _, t in
               _pairs(loaded, loaded))


# ---------------------------------------------------------------------------
# the three repairs
# ---------------------------------------------------------------------------


def _selective_scan_before(decay, drive):
    """``models/ssm.py:_selective_scan`` as it was, with its in-place
    write into the tensor the product saved for backward."""
    a, b = decay, drive.clone()
    S, off = b.shape[1], 1
    while off < S:
        b[:, off:] = a[:, off:] * b[:, :-off] + b[:, off:]
        if 2 * off < S:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


@pytest.mark.parametrize("shape,decay_shape", [
    ((2, 13, 6, 4), (2, 13, 6, 4)),        # Mamba-1: decay per element
    ((1, 32, 3, 8), (1, 32, 3, 1)),        # Mamba-2: decay per head
])
def test_selective_scan_backward_matches_jax_grad(shape, decay_shape):
    """Forward bit-equal to the implementation before the repair; the
    gradients of a weighted sum with respect to decay and drive within
    rtol 1e-5 of ``jax.grad`` of the reference's ``_selective_scan`` (and
    atol 1e-5 of the largest: the reference scans the per-head decay
    broadcast to drive's shape, as its Mamba-2 does, and sums its gradient
    over the lanes after; the port combines it at its own size, as its
    Mamba-2 does, so the sums run in another order). The implementation
    before the repair cannot be differentiated."""
    rng = np.random.RandomState(6)
    decay = rng.uniform(0.5, 1.0, decay_shape).astype(np.float32)
    drive = rng.randn(*shape).astype(np.float32)
    weight = rng.randn(*shape).astype(np.float32)
    td, tv = (torch.from_numpy(x).requires_grad_() for x in (decay, drive))
    h = tssm._selective_scan(td, tv)
    assert torch.equal(h, _selective_scan_before(td.detach(), tv.detach()))
    gd, gv = torch.autograd.grad((h * torch.from_numpy(weight)).sum(),
                                 (td, tv))
    want = jax.grad(lambda d, v: jnp.sum(jssm._selective_scan(
        jnp.broadcast_to(d, v.shape), v) * weight), argnums=(0, 1))(
            jnp.asarray(decay), jnp.asarray(drive))
    for got, w in zip((gd, gv), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
    with pytest.raises(RuntimeError, match="inplace"):
        torch.autograd.grad(_selective_scan_before(td, tv).sum(), (td, tv))


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


@pytest.mark.parametrize("B,S,T,H,K,hd", [(2, 9, 9, 4, 2, 16),
                                          (1, 5, 12, 6, 1, 32)])
def test_tensor_core_route_backward_matches_upcast_autograd(B, S, T, H, K,
                                                            hd):
    """``sdpa_tc``'s products under autograd (``_MatmulF32``, forward on
    the CPU by the upcast) on bf16 q, k, v: the output and dq, dk, dv
    within 1e-6 norm-wise of autograd through ``sdpa_f32``'s upcast
    branch."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(B, n, hds, hd).astype(
        np.float32)).to(torch.bfloat16) for n, hds in
        ((S, H), (T, K), (T, K)))
    mask = torch.where(torch.from_numpy(rng.rand(1, S, T) < 0.2),
                       torch.tensor(-1e9), torch.tensor(0.0))
    cot = torch.from_numpy(rng.randn(B, S, H, hd).astype(np.float32))
    outs = {}
    for route in ("tc", "upcast"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn = tattn.sdpa_tc if route == "tc" else tattn.sdpa_f32
        out = fn(*leaves, mask, hd ** -0.5)
        outs[route] = (out.detach(), *torch.autograd.grad(
            (out * cot).sum(), leaves))
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got, want = outs["tc"][i], outs["upcast"][i]
        assert got.dtype == want.dtype, name
        assert _rel(got, want) <= 1e-6, (name, _rel(got, want))
    assert outs["tc"][1].dtype == torch.bfloat16


def _wrapper_calls():
    """Each of the seven kernel wrappers with small CPU inputs: (name, fn,
    float inputs)."""
    from repro_torch.kernels.bottleneck import ops as bops
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssm_scan import ops as sops
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    B, H, K, hd, W, P, page = 2, 4, 2, 16, 8, 5, 4
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    codes = torch.randint(-127, 128, (3, 6), generator=g).to(torch.int8)
    return [
        ("decode_attention", dops.decode_attention,
         (r(B, H, hd), r(B, W, K, hd), r(B, W, K, hd), torch.zeros(B, W))),
        ("paged_decode_attention",
         lambda q, k, v, b: dops.paged_decode_attention(q, k, v, table, b),
         (r(B, H, hd), r(P, page, K, hd), r(P, page, K, hd),
          torch.zeros(B, 2 * page))),
        ("paged_verify_attention",
         lambda q, k, v, b: dops.paged_verify_attention(q, k, v, table, b),
         (r(B, 3, H, hd), r(P, page, K, hd), r(P, page, K, hd),
          torch.zeros(B, 3, 2 * page))),
        ("flash_attention", fops.flash_attention,
         (r(B, 8, H, hd), r(B, 8, K, hd), r(B, 8, K, hd))),
        ("bottleneck_encode", bops.bottleneck_encode, (r(3, 32), r(32, 6))),
        ("bottleneck_decode",
         lambda s, w: bops.bottleneck_decode(codes, s, w),
         (r(3, 1).abs(), r(6, 32))),
        ("ssm_scan", sops.chunked_scan,
         (r(1, 8, 3, 2).sigmoid(), r(1, 8, 3, 2))),
    ]


@pytest.mark.parametrize("i", range(7))
def test_kernel_wrappers_refuse_under_grad_and_run_without(i):
    """Under grad with an input that requires it, each wrapper raises
    naming its kernel (the TPU kernel it ports has no gradient); under
    ``no_grad`` and ``inference_mode`` it runs its plain version."""
    name, fn, inputs = _wrapper_calls()[i]
    leaves = [t.clone().requires_grad_() for t in inputs]
    with pytest.raises(RuntimeError, match=f"{name}: .*no gradient"):
        fn(*leaves)
    with torch.no_grad():
        want = fn(*leaves)
    with torch.inference_mode():
        got = fn(*inputs)
    for w, g in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (want, got))):
        assert torch.equal(w, g)
    fn(*inputs)                          # nothing requires grad: runs


def test_reference_cannot_differentiate_its_kernels():
    """The reference refuses too: ``jax.grad`` through its flash attention
    and chunked scan (interpret mode) raises."""
    from repro.kernels.flash_attention import ops as jflash
    from repro.kernels.ssm_scan import ops as jscan
    rng = np.random.RandomState(8)
    q = jnp.asarray(rng.randn(1, 16, 2, 32).astype(np.float32))
    d = jnp.asarray(rng.rand(1, 16, 4, 2).astype(np.float32))

    def flash(x):
        return jnp.sum(jflash.flash_attention(x, q, q, causal=True,
                                              block_q=8, block_k=8))

    def scan(x):
        return jnp.sum(jscan.chunked_scan(x, x, chunk=8))
    for fn, x in ((flash, q), (scan, d)):
        assert np.isfinite(float(fn(x)))        # the forward runs
        with pytest.raises(AssertionError):
            jax.grad(fn)(x)


def test_train_step_takes_parameters_made_under_inference_mode():
    """Parameters made under ``torch.inference_mode`` (as serving makes
    them) train through clones, with the same step as from normal
    tensors; the step itself refuses to run under that mode."""
    from repro_torch.models import init_params, make_train_step
    cfg = tconfigs.get_reduced("phi4-mini-3.8b")
    batch = {k: torch.from_numpy(v) for k, v in tlm.lm_batch(
        np.random.RandomState(0), cfg, 2, 8).items()}
    opt = toptim.adamw(toptim.constant(1e-3))
    step = make_train_step(cfg, opt)
    with torch.inference_mode():
        frozen = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plain = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got, _, gm = step(frozen, opt.init(frozen), batch)
    want, _, wm = step(plain, opt.init(plain), batch)
    assert torch.equal(gm["total_loss"], wm["total_loss"])
    for path, w, g in _pairs(want, got):
        assert torch.equal(w, g), path
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="inference_mode"):
        step(plain, opt.init(plain), batch)
