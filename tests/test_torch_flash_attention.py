"""Flash attention (K2 forward/carry, K3 backward) of the PyTorch port
against the JAX package.

The port's plain versions (what its wrappers run on a CPU tensor) are held
against the JAX ``flash_attention`` / ``flash_attention_carry`` (Pallas,
interpret mode on the CPU) on the same numpy inputs, at the tolerances of
``tests/test_pallas.py``: 2e-5 on outputs, 1e-4 on gradients. The CUDA
kernels themselves only run on a card: ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.pallas import flash_attention as jax_flash
from mxnet_tpu.pallas import flash_attention_carry as jax_carry

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.kernels import flash_attention as K


def _qkv(seed, b=2, h=3, s_q=24, s_kv=None, d=16):
    rs = np.random.RandomState(seed)
    s_kv = s_q if s_kv is None else s_kv
    return (rs.normal(size=(b, h, s_q, d)).astype(np.float32),
            rs.normal(size=(b, h, s_kv, d)).astype(np.float32),
            rs.normal(size=(b, h, s_kv, d)).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _loss_jax(causal, block_q):
    def f(q, k, v):
        return jnp.sum(jnp.sin(jax_flash(q, k, v, causal, None, block_q)))
    return f


def _port_grads(q, k, v, causal, block_q=None):
    tq, tk, tv = _t(q, k, v, grad=True)
    out = K.flash_attention(tq, tk, tv, causal=causal, block_q=block_q)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


# (s_q, s_kv, block_q): even, the uneven S = 19 with block_q 8 (the JAX
# side pads to 24), and unequal lengths (33, 65)
CASES = [(24, 24, None), (19, 19, 8), (33, 65, None)]


@pytest.mark.parametrize("s_q,s_kv,block_q", CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(s_q, s_kv, block_q, causal):
    q, k, v = _qkv(0, s_q=s_q, s_kv=s_kv)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, None, block_q))
    got = K.flash_attention(*_t(q, k, v), causal=causal, block_q=block_q)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s_q,s_kv,block_q", CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(s_q, s_kv, block_q, causal):
    q, k, v = _qkv(1, b=1, h=2, s_q=s_q, s_kv=s_kv, d=8)
    want = jax.grad(_loss_jax(causal, block_q), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, got = _port_grads(q, k, v, causal, block_q)
    for name, a, b in zip("qkv", got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg="d" + name)


def _carry_init(bh, s_q, d):
    return (np.zeros((bh, s_q, d), np.float32),
            np.full((bh, s_q), K.NEG_INF, np.float32),
            np.zeros((bh, s_q), np.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_carry_chain_matches_one_call_and_jax(causal):
    """Two K/V halves merged one after the other, with the offsets ring
    attention gives them, equal one call over the whole K/V and JAX's
    chained carry."""
    bh, s, d = 4, 16, 8
    rs = np.random.RandomState(2)
    q = rs.normal(size=(bh, s, d)).astype(np.float32)
    k = rs.normal(size=(bh, 2 * s, d)).astype(np.float32)
    v = rs.normal(size=(bh, 2 * s, d)).astype(np.float32)
    q_off = s              # the second sequence block's queries
    halves = [(k[:, :s], v[:, :s], 0), (k[:, s:], v[:, s:], s)]

    carry = [torch.from_numpy(a) for a in _carry_init(bh, s, d)]
    jcarry = [jnp.asarray(a) for a in _carry_init(bh, s, d)]
    for kh, vh, kv_off in halves:
        carry = K.flash_attention_carry(torch.from_numpy(q),
                                        torch.from_numpy(kh.copy()),
                                        torch.from_numpy(vh.copy()), *carry,
                                        q_offset=q_off, kv_offset=kv_off,
                                        causal=causal)
        jcarry = jax_carry(jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh),
                           *jcarry, q_offset=q_off, kv_offset=kv_off,
                           causal=causal)
    whole = K.flash_attention_carry(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        *[torch.from_numpy(a) for a in _carry_init(bh, s, d)],
        q_offset=q_off, kv_offset=0, causal=causal)
    o, m, l = carry
    for got, want in ((o, jcarry[0]), (m, jcarry[1]), (l, jcarry[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    out = (o / l[..., None]).numpy()
    np.testing.assert_allclose(out, (whole[0] / whole[2][..., None]).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_carry_fully_masked_rows_leave_the_carry_unchanged():
    """Keys wholly after every query (kv_offset past q_offset + Sq) under a
    causal mask: every p is 0, so o and l stay as they came in — even in
    rows that have seen no key yet (m = NEG_INF, where exp(s - m) = 1)."""
    bh, s, d = 2, 8, 4
    rs = np.random.RandomState(3)
    q, k, v = (rs.normal(size=(bh, s, d)).astype(np.float32)
               for _ in range(3))
    o = rs.normal(size=(bh, s, d)).astype(np.float32)
    m = rs.normal(size=(bh, s)).astype(np.float32)
    l = rs.rand(bh, s).astype(np.float32)
    m[0] = K.NEG_INF          # rows that have seen nothing yet
    l[0] = 0.0
    o[0] = 0.0
    args = [torch.from_numpy(a) for a in (q, k, v, o, m, l)]
    o2, m2, l2 = K.flash_attention_carry(*args, q_offset=0, kv_offset=s,
                                         causal=True)
    np.testing.assert_array_equal(o2.numpy(), o)
    np.testing.assert_array_equal(l2.numpy(), l)
    np.testing.assert_array_equal(m2.numpy(), m)
    jo, jm, jl = jax_carry(*[jnp.asarray(a) for a in (q, k, v, o, m, l)],
                           q_offset=0, kv_offset=s, causal=True)
    np.testing.assert_array_equal(np.asarray(jo), o)
    np.testing.assert_array_equal(np.asarray(jl), l)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax(causal):
    """bf16 inputs: p is rounded to bf16 before p @ v on both sides, and
    the output rounds once to bf16, so the two agree to a few bf16 ulps
    (2e-2 absolute on outputs of magnitude below 1; gradients, computed in
    fp32 from the same bf16 values, to 5e-2 on values up to about 5)."""
    q, k, v = _qkv(4, s_q=19)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal, None, 8), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    got = K.flash_attention(tq, tk, tv, causal=causal, block_q=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               rtol=2e-2, atol=2e-2)

    def f(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal, None, 8)
                       .astype(jnp.float32) ** 2)
    jg = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    (got.float() ** 2).sum().backward()
    for name, t, b in zip("qkv", (tq, tk, tv), jg):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(b, np.float32), rtol=5e-2,
                                   atol=5e-2, err_msg="d" + name)


def test_bwd_wrapper_matches_plain_version_and_jax_vjp():
    """The K3 wrapper on CPU tensors is its plain version; both give the
    gradients JAX's custom VJP gives from the same saved (out, lse)."""
    q, k, v = _qkv(5, b=1, h=2, s_q=20, d=8)
    g = np.random.RandomState(6).normal(size=q.shape).astype(np.float32)
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = K.flash_attention_forward(tq, tk, tv, causal=True)
    flat = lambda t: t.reshape(2, t.shape[2], -1)  # noqa: E731
    delta = (tg * out).sum(-1)
    got = K.flash_attention_bwd(flat(tq), flat(tk), flat(tv), flat(tg),
                                lse.reshape(2, -1), delta.reshape(2, -1),
                                causal=True)
    plain = K.flash_attention_bwd_reference(
        flat(tq), flat(tk), flat(tv), flat(tg), lse.reshape(2, -1),
        delta.reshape(2, -1), causal=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    for a, b, c in zip(got, plain, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.reshape(q.shape).numpy(), np.asarray(c),
                                   rtol=1e-4, atol=1e-4)


def test_wrapper_checks_dispatch_and_meta():
    q, k, v = _t(*_qkv(7, s_q=10, s_kv=12))
    before = (K.fwd_launches, K.bwd_launches)
    out = K.flash_attention(q, k, v, causal=True)      # CPU: plain versions
    assert (K.fwd_launches, K.bwd_launches) == before
    # meta tensors only propagate shapes
    mq, mk, mv = (t.to("meta") for t in (q, k, v))
    mo = K.flash_attention(mq, mk, mv)
    assert mo.device.type == "meta" and mo.shape == out.shape
    bh = 6
    o, m, l = K.flash_attention_carry(
        mq.reshape(bh, 10, 16), mk.reshape(bh, 12, 16), mv.reshape(bh, 12, 16),
        torch.empty((bh, 10, 16), device="meta"),
        torch.empty((bh, 10), device="meta"),
        torch.empty((bh, 10), device="meta"))
    assert (o.shape, m.shape, l.shape) == ((bh, 10, 16), (bh, 10), (bh, 10))
    dq, dk, dv = K.flash_attention_bwd(
        mq.reshape(bh, 10, 16), mk.reshape(bh, 12, 16), mv.reshape(bh, 12, 16),
        mq.reshape(bh, 10, 16), torch.empty((bh, 10), device="meta"),
        torch.empty((bh, 10), device="meta"))
    assert dk.shape == (bh, 12, 16) and dq.shape == (bh, 10, 16)
    q3 = q.reshape(bh, 10, 16)
    o0, m0, l0 = (torch.zeros(bh, 10, 16), torch.zeros(bh, 10),
                  torch.zeros(bh, 10))
    with pytest.raises(mt.MXNetError, match="dtype"):
        K.flash_attention_carry(q3.double(), q3.double(), q3.double(),
                                o0, m0, l0)
    with pytest.raises(mt.MXNetError, match="do not match"):
        K.flash_attention_carry(q3, q3[:, :, :8], q3, o0, m0, l0)
    with pytest.raises(mt.MXNetError, match="o must be float32"):
        K.flash_attention_carry(q3, q3, q3, o0[:, :5], m0, l0)
    with pytest.raises(mt.MXNetError, match="head dim"):
        big = torch.zeros(1, 4, 256)
        K.flash_attention_carry(big, big, big, big, torch.zeros(1, 4),
                                torch.zeros(1, 4))
    with pytest.raises(mt.MXNetError, match="B, H, S, D"):
        K.flash_attention(q3, q3, q3)


# -- the kernels' numerics on the CPU: split TF32 and bf16-rounded p/ds -------

def test_split_tf32_rounds_ties_away_and_keeps_fp32_accuracy():
    """hi keeps 10 mantissa bits (the low 13 are zero), rounded to nearest
    with ties away from zero; hi + lo is x to about 2^-22 relative."""
    one_and_half_ulp = np.float32(1.0 + 2.0 ** -11)      # a tie at tf32
    x = np.array([one_and_half_ulp, -one_and_half_ulp, 1.0 + 2.0 ** -12,
                  3.0], np.float32)
    hi, lo = K.split_tf32(torch.from_numpy(x))
    np.testing.assert_array_equal(
        hi.numpy(), np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                              3.0], np.float32))
    r = torch.from_numpy(np.random.RandomState(8).normal(size=4096)
                         .astype(np.float32) * 100)
    hi, lo = K.split_tf32(r)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi + lo - r).abs() / r.abs()).max()) < 2.0 ** -21


def _plain_fwd_bwd(q, k, v, g, causal, matmul=torch.matmul, ps_dtype=None):
    """The plain forward (carry reference from the empty carry, then the
    normalisation) and backward on (B, H, S, D) numpy inputs of one type."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    bh = b * h
    tq, tk, tv, tg = (t.reshape(bh, -1, d) for t in (q, k, v, g))
    o, m, l = K.flash_attention_carry_reference(
        tq, tk, tv, torch.zeros(bh, s_q, d), torch.full((bh, s_q), K.NEG_INF),
        torch.zeros(bh, s_q), 0, 0, causal, matmul=matmul)
    l = torch.clamp_min(l, 1e-30)
    out = (o / l[..., None]).to(q.dtype)
    lse = m + torch.log(l)
    delta = (tg.float() * out.float()).sum(-1)
    grads = K.flash_attention_bwd_reference(tq, tk, tv, tg, lse, delta, causal,
                                            matmul=matmul, ps_dtype=ps_dtype)
    return (out.reshape(b, h, s_q, d),
            [x.reshape(b, h, n, d) for x, n in zip(grads, (s_q, s_kv, s_kv))])


# (B, H, Sq, Skv, D): the LM's head dim 64, and a ragged shape
NUMERICS_SHAPES = [(1, 2, 64, 64, 64), (1, 3, 33, 65, 20)]


@pytest.mark.parametrize("shape", NUMERICS_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_products_match_jax(shape, causal):
    """Every product of the plain forward and backward taken as the fp32
    kernels take it (lo.hi + hi.lo + hi.hi of the tf32 parts) stays within
    the fp32 tolerances of JAX's flash attention and its VJP: 2e-5 on the
    output, 1e-4 on the gradients."""
    b, h, s_q, s_kv, d = shape
    q, k, v = _qkv(9, b=b, h=h, s_q=s_q, s_kv=s_kv, d=d)
    g = np.random.RandomState(10).normal(size=q.shape).astype(np.float32)
    out, grads = _plain_fwd_bwd(*_t(q, k, v, g), causal,
                                matmul=K.matmul_3xtf32)
    want, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for name, a, w in zip("qkv", grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg="d" + name)


@pytest.mark.parametrize("shape", NUMERICS_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_rounded_p_and_ds_match_jax(shape, causal):
    """bf16 inputs with p and ds rounded to bf16 as operands of dv, dq and
    dk (as the bf16 backward kernel takes them) stay within the bf16
    tolerance of JAX's gradients on the same bf16 inputs, scaled by the
    largest gradient: 2e-2."""
    b, h, s_q, s_kv, d = shape
    q, k, v = _qkv(11, b=b, h=h, s_q=s_q, s_kv=s_kv, d=d)
    g = np.random.RandomState(12).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal), jq, jk, jv)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    _, grads = _plain_fwd_bwd(tq, tk, tv, tg, causal,
                              ps_dtype=torch.bfloat16)
    for name, a, w in zip("qkv", grads, vjp(jg)):
        w = np.asarray(w, np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(a.to(torch.bfloat16).float().numpy(), w,
                                   rtol=0, atol=2e-2 * scale,
                                   err_msg="d" + name)
