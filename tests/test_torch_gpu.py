"""Card-only tests of the PyTorch port (marker ``gpu``).

They need a CUDA device: the hand-written kernels have no CPU mode.
Without one each test skips with its reason. This file imports only the
port (the machine with the card has no JAX), so on that machine it runs
without the JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import fused_bn as K
from mxnet_tpu_torch.kernels import flash_attention as FA
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet

pytestmark = pytest.mark.gpu

SHAPES = [(2, 56, 56, 256), (1, 7, 7, 2048), (3, 5, 7, 33), (2, 20, 7, 33),
          (2, 2, 2, 600)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(dtype, shape):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    r = torch.randn(shape, generator=g, device="cuda").to(dtype)
    s = torch.randn(c, generator=g, device="cuda")
    b = torch.randn(c, generator=g, device="cuda")
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for res in (r, None):
        before = K.launches
        got = K.scale_bias_add_relu(x, s, b, res)
        torch.cuda.synchronize()
        assert K.launches == before + 1
        want = K.scale_bias_add_relu_reference(x, s, b, res)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_kernel_takes_unaligned_views():
    """A view starting one element in is not 16-byte aligned: the kernel
    takes its scalar path and still agrees."""
    _need_card()
    base = torch.randn(4 * 64 + 1, device="cuda")
    x = base[1:].view(4, 64)
    s, b = torch.randn(64, device="cuda"), torch.randn(64, device="cuda")
    got = K.scale_bias_add_relu(x, s, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, K.scale_bias_add_relu_reference(x, s, b),
                               rtol=1e-6, atol=1e-6)


def test_small_resnet_on_card_matches_cpu(monkeypatch):
    """The port's fused-tail ResNet v1 served on the card (one kernel launch
    per block tail per forward) agrees with the port on the CPU; TF32 is
    off so both sides compute in fp32."""
    _need_card()
    monkeypatch.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    mt.layout.set_default_layout("NHWC")
    try:
        with mt.name.NameManager():
            net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                  [16, 32, 64, 128, 256], classes=10)
    finally:
        mt.layout.set_default_layout(None)
    gpu = mt.gpu(0)
    net.initialize(mt.init.Xavier(generator=torch.Generator().manual_seed(0)),
                   ctx=gpu)
    x = np.random.RandomState(0).uniform(-1, 1, (3, 32, 32, 3)) \
        .astype(np.float32)
    before = K.launches
    eager = net(mt.nd.array(x, ctx=gpu)).asnumpy()
    assert K.launches == before + 4
    sym = net(mt.sym.Variable("data"))
    params = {("aux:" if n in sym.list_auxiliary_states() else "arg:") + n:
              p.data() for n, p in net.collect_params().items()}
    with mt.serving.InferenceEngine(sym, params, {"data": (1, 32, 32, 3)},
                                    max_batch=4, ctx=gpu) as eng:
        served = eng.predict(data=x)[0]
    cpu = mt.predictor.Predictor(
        sym, {k: v.as_in_context(mt.cpu()) for k, v in params.items()},
        {"data": x.shape}, ctx=mt.cpu())
    want = cpu.forward(data=x)[0].asnumpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(eager, want, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(served, want, rtol=1e-4, atol=1e-4 * scale)


# -- K1 under autograd: the ResNet training slice ----------------------------

TAIL_SHAPES = [(32, 56, 56, 256), (32, 7, 7, 2048), (3, 5, 7, 33),
               (2, 2, 2, 600)]


def _masked_tail(x, scale, bias, residual, mask):
    """The plain block tail (``scale_bias_add_relu_reference``'s ops) with
    the ReLU's branch given per element, in place of the sign of its own
    sum: the plain version recomputed on another computation's branches
    (a bf16 sum within an ulp of zero can land on either side)."""
    y = x * scale.to(x.dtype) + bias.to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.where(mask, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TAIL_SHAPES)
def test_kernel_backward_matches_plain_version(shape, dtype, residual):
    """The kernel forward under ``torch.autograd.Function`` against
    autograd through the plain version, with the incoming gradient a
    non-contiguous view (as cuDNN's channels-last permutations hand it
    over): forward bit-equal in fp32, within 2e-2 in bf16; gradients
    within 1e-5 (fp32) and 2e-2 (bf16) of the largest magnitude; one
    launch per forward. The plain version's backward takes the kernel's
    ReLU branches: in bf16 the kernel rounds the sum once and the plain
    chain after each op, so a sum within an ulp of zero lands on either
    side (0.03% of the elements measured), and the gradient of such an
    element is all or nothing; in fp32 no branch may differ."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    c = shape[-1]
    rnd = lambda s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    x, r = rnd(shape).to(dtype), rnd(shape).to(dtype)
    s, b = rnd((c,)) + 1.0, rnd((c,))
    perm = (0, 3, 1, 2)
    grad = rnd(tuple(shape[i] for i in perm)).to(dtype).permute(0, 2, 3, 1)
    assert not grad.is_contiguous()
    ins = [x, s, b] + ([r] if residual else [])
    leaves = [t.clone().requires_grad_() for t in ins]
    ref_leaves = [t.clone().requires_grad_() for t in ins]
    before = K.launches
    out = K.scale_bias_add_relu(*leaves[:3],
                                leaves[3] if residual else None)
    assert K.launches == before + 1
    assert type(out.grad_fn).__name__ == "_ScaleBiasAddReLUBackward"
    res_in = ref_leaves[3] if residual else None
    want = K.scale_bias_add_relu_reference(*ref_leaves[:3], res_in)
    mask = out.detach() > 0
    flips = int((mask != (want.detach() > 0)).sum())
    masked = _masked_tail(*ref_leaves[:3], res_in, mask)
    got_g = torch.autograd.grad(out, leaves, grad)
    want_g = torch.autograd.grad(masked, ref_leaves, grad)
    torch.cuda.synchronize()
    assert K.launches == before + 1          # the backward launches nothing
    if dtype == torch.float32:
        assert torch.equal(out, want) and flips == 0
    assert flips <= 1e-3 * out.numel(), flips
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    _close(out, want, tol)
    for a, w in zip(got_g, want_g):
        assert a.dtype == w.dtype
        scale = w.float().abs().max().item()
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=tol * max(scale, 1e-30))


def test_block_tail_gradients_reach_every_input_on_card():
    """The repaired fault: through the kernel, the channels-last
    ``_contrib_BatchNormAddReLU`` in training mode passes gradients to
    data, addend, gamma and beta (they were silently lost), equal to the
    CPU's within 1e-4 of the largest magnitude (TF32 plays no part)."""
    _need_card()
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("_contrib_BatchNormAddReLU")
    rs = np.random.RandomState(5)
    shape, c = (8, 7, 7, 64), 64
    host = [rs.randn(*shape), rs.randn(*shape), rs.rand(c) + 0.5,
            rs.randn(c), rs.randn(c), rs.rand(c) + 0.5]
    cot = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    res = {}
    for dev in ("cuda", "cpu"):
        t = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in host]
        leaves = [a.requires_grad_() for a in t[:4]]
        before = K.launches
        out = op.fn(*leaves, *t[4:], axis=3, eps=1e-5, fix_gamma=False,
                    _train=True)[0]
        assert K.launches == before + (dev == "cuda")
        res[dev] = [gr.cpu() for gr in torch.autograd.grad(
            out, leaves, cot.to(dev))]
    for a, b, name in zip(res["cuda"], res["cpu"],
                          ("data", "addend", "gamma", "beta")):
        assert float(a.abs().max()) > 0, name
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def _raw_steps(net, x, y, steps, ctx):
    """``bench.py``'s raw step in fp32 through ``make_pure_fn``: SGD
    momentum 0.9, lr 0.05, BN running stats from the aux map."""
    from mxnet_tpu_torch.gluon.block import make_pure_fn
    from mxnet_tpu_torch.ops import optimizer_ops as O
    dev = ctx.torch_device()
    fn, raw, names = make_pure_fn(net, train=True)
    master = [r.detach().to(dev, copy=True) for r in raw]
    mom = [torch.zeros_like(m) for m in master]
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    losses = []
    for _ in range(steps):
        full = [m.detach().requires_grad_() for m in master]
        (logits,), aux = fn(full, [xt])
        loss = -torch.log_softmax(logits, -1).gather(1, yt[:, None]).mean()
        grads = torch.autograd.grad(loss, full, allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for i, gr in enumerate(grads):
                if i in aux:
                    master[i] = aux[i]
                elif gr is not None:
                    master[i], mom[i] = O.sgd_mom_update(
                        master[i], gr, mom[i], lr=0.05, momentum=0.9)
    return losses, [m.cpu().numpy() for m in master], names


def test_small_resnet_raw_step_on_card_matches_cpu(monkeypatch):
    """Two raw training steps of the small fused-tail ResNet v1 on the
    card (4 kernel launches per step) and on the CPU from the same
    weights, TF32 off: losses within 1e-4 relative, every weight within
    1e-3 of its tensor's largest magnitude (the conv biases: of all
    weights')."""
    _need_card()
    monkeypatch.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mt.layout.set_default_layout("NHWC")
    try:
        with mt.name.NameManager():
            net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                  [8, 16, 32, 64, 128], classes=10,
                                  thumbnail=True)
    finally:
        mt.layout.set_default_layout(None)
    net.initialize(mt.init.Xavier(generator=torch.Generator().manual_seed(0)),
                   ctx=mt.cpu())
    net(mt.nd.zeros((1, 32, 32, 3), ctx=mt.cpu()))
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (16, 32, 32, 3)).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.int64)
    before = K.launches
    card = _raw_steps(net, x, y, 2, mt.gpu(0))
    assert K.launches == before + 8
    host = _raw_steps(net, x, y, 2, mt.cpu())
    np.testing.assert_allclose(card[0], host[0], rtol=1e-4)
    assert card[0][1] < card[0][0]
    largest = max(np.abs(b).max() for b in host[1])
    for n, a, b in zip(card[2], card[1], host[1]):
        # a conv bias ahead of a BatchNorm has a zero gradient in exact
        # arithmetic: its value is rounding noise on both sides, held to
        # the largest magnitude of all weights
        scale = largest if "conv" in n and n.endswith("_bias") \
            else np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * max(scale, 1e-30), err_msg=n)


# -- flash attention: K2 (forward / carry) and K3 (backward) ----------------

# (B, H, Sq, Skv, D): small, ragged in both lengths, head dims 3..128 (3,
# 20 and 72 take the plain-load path in bf16, 3 also in fp32)
ATTN_SHAPES = [(1, 2, 64, 64, 64), (2, 3, 19, 19, 8), (1, 2, 33, 65, 16),
               (1, 2, 100, 70, 40), (1, 1, 130, 130, 128),
               (1, 2, 50, 37, 3), (2, 2, 70, 90, 20), (1, 2, 96, 130, 72)]


def _attn_inputs(shape, dtype, seed=0):
    b, h, s_q, s_kv, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda s: torch.randn((b, h, s, d), generator=g,  # noqa: E731
                                device="cuda").to(dtype)
    return rnd(s_q), rnd(s_kv), rnd(s_kv), rnd(s_q)


def _close(got, want, tol):
    want = want.float()
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_flash_kernels_match_plain_versions(shape, causal, dtype, monkeypatch):
    """K2 (with its normalising epilogue) and K3 against the plain
    versions on the same CUDA tensors, TF32 off; one launch each."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b, h, s_q, s_kv, d = shape
    q, k, v, g = _attn_inputs(shape, dtype)
    tol_f, tol_b = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    before = (FA.fwd_launches, FA.bwd_launches)
    out, lse = FA.flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert (FA.fwd_launches, FA.bwd_launches) == (before[0] + 1, before[1])
    bh = b * h
    flat = lambda x: x.reshape(bh, x.shape[2], d)  # noqa: E731
    o0 = torch.zeros((bh, s_q, d), device="cuda")
    m0 = torch.full((bh, s_q), FA.NEG_INF, device="cuda")
    l0 = torch.zeros((bh, s_q), device="cuda")
    o, m, l = FA.flash_attention_carry_reference(flat(q), flat(k), flat(v),
                                                 o0, m0, l0, 0, 0, causal)
    l = torch.clamp_min(l, 1e-30)
    _close(out, (o / l[..., None]).to(dtype).reshape(out.shape), tol_f)
    _close(lse, (m + torch.log(l)).reshape(lse.shape), tol_f)
    delta = (g.float() * out.float()).sum(-1).reshape(bh, s_q)
    args = (flat(q), flat(k), flat(v), flat(g), lse.reshape(bh, s_q), delta,
            causal)
    grads = FA.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert FA.bwd_launches == before[1] + 1
    for got, want in zip(grads, FA.flash_attention_bwd_reference(*args)):
        assert got.dtype == dtype
        _close(got, want, tol_b)


def _plain_normalised(q, k, v, causal):
    b, h, s_q, d = q.shape
    bh = b * h
    flat = lambda x: x.reshape(bh, x.shape[2], d)  # noqa: E731
    o, m, l = FA.flash_attention_carry_reference(
        flat(q), flat(k), flat(v), torch.zeros((bh, s_q, d), device=q.device),
        torch.full((bh, s_q), FA.NEG_INF, device=q.device),
        torch.zeros((bh, s_q), device=q.device), 0, 0, causal)
    l = torch.clamp_min(l, 1e-30)
    return ((o / l[..., None]).to(q.dtype).reshape(q.shape),
            (m + torch.log(l)).reshape(b, h, s_q))


def test_flash_kernels_take_unaligned_views(monkeypatch):
    """Inputs that start one element into their storage (base not 16-byte
    aligned) take the plain-load path and still agree with the plain
    versions, forward and backward."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bh, s, d = 3, 70, 64
    g = torch.Generator(device="cuda").manual_seed(4)
    views = []
    for _ in range(4):
        base = torch.randn(bh * s * d + 1, generator=g, device="cuda")
        views.append(base[1:].view(1, bh, s, d))
    q, k, v, gr = views
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    out, lse = FA.flash_attention_forward(q, k, v, True)
    want_out, want_lse = _plain_normalised(q, k, v, True)
    _close(out, want_out, 2e-5)
    _close(lse, want_lse, 2e-5)
    delta = (gr.float() * out.float()).sum(-1).reshape(bh, s)
    args = (q[0], k[0], v[0], gr[0], lse.reshape(bh, s), delta, True)
    for got, want in zip(FA.flash_attention_bwd(*args),
                         FA.flash_attention_bwd_reference(*args)):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("mode", ["normalised", "carry"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ragged_bh3(causal, dtype, mode, monkeypatch):
    """BH 3 with ragged Sq 100 / Skv 150: the normalised forward and the
    backward, or a carry call with ring offsets, against the plain
    versions."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    shape = (1, 3, 100, 150, 64)
    q, k, v, gr = _attn_inputs(shape, dtype, seed=5)
    tol_f, tol_b = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    if mode == "carry":
        qf, kf, vf = q[0], k[0], v[0]
        gen = torch.Generator(device="cuda").manual_seed(6)
        o = torch.randn((3, 100, 64), generator=gen, device="cuda")
        m = torch.randn((3, 100), generator=gen, device="cuda")
        l = torch.rand((3, 100), generator=gen, device="cuda") + 0.5
        kw = dict(q_offset=120, kv_offset=30, causal=causal)
        got = FA.flash_attention_carry(qf, kf, vf, o, m, l, **kw)
        want = FA.flash_attention_carry_reference(qf, kf, vf, o, m, l, **kw)
        for a, b in zip(got, want):
            _close(a, b, tol_f)
        return
    out, lse = FA.flash_attention_forward(q, k, v, causal)
    want_out, want_lse = _plain_normalised(q, k, v, causal)
    _close(out, want_out, tol_f)
    _close(lse, want_lse, tol_f)
    delta = (gr.float() * out.float()).sum(-1).reshape(3, 100)
    args = (q[0], k[0], v[0], gr[0], lse.reshape(3, 100), delta, causal)
    for got, want in zip(FA.flash_attention_bwd(*args),
                         FA.flash_attention_bwd_reference(*args)):
        _close(got, want, tol_b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(dtype):
    """K3 twice on the same inputs gives bit-equal dq, dk and dv (no
    floating-point atomics)."""
    _need_card()
    shape = (2, 4, 300, 300, 64)
    q, k, v, gr = _attn_inputs(shape, dtype, seed=7)
    out, lse = FA.flash_attention_forward(q, k, v, True)
    delta = (gr.float() * out.float()).sum(-1).reshape(8, 300)
    flat = lambda x: x.reshape(8, 300, 64)  # noqa: E731
    args = (flat(q), flat(k), flat(v), flat(gr), lse.reshape(8, 300), delta,
            True)
    first = FA.flash_attention_bwd(*args)
    second = FA.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_carry_chain_on_card(causal, monkeypatch):
    """Two key halves merged with ring offsets equal one call over all the
    keys and the plain version's chain; each carry call is one launch."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bh, s, d = 6, 70, 32
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((bh, s, d), generator=g, device="cuda")
    k = torch.randn((bh, 2 * s, d), generator=g, device="cuda")
    v = torch.randn((bh, 2 * s, d), generator=g, device="cuda")

    def init():
        return (torch.zeros((bh, s, d), device="cuda"),
                torch.full((bh, s), FA.NEG_INF, device="cuda"),
                torch.zeros((bh, s), device="cuda"))

    def chain(fn):
        c = init()
        for off in (0, s):
            c = fn(q, k[:, off:off + s].contiguous(),
                   v[:, off:off + s].contiguous(), *c, q_offset=s,
                   kv_offset=off, causal=causal)
        return c

    before = FA.fwd_launches
    got = chain(FA.flash_attention_carry)
    assert FA.fwd_launches == before + 2
    want = chain(FA.flash_attention_carry_reference)
    for a, b in zip(got, want):
        _close(a, b, 2e-5)
    whole = FA.flash_attention_carry(q, k, v, *init(), q_offset=s,
                                     kv_offset=0, causal=causal)
    _close(got[0] / got[2][..., None], whole[0] / whole[2][..., None], 2e-5)


def test_flash_carry_fully_masked_rows_unchanged_on_card():
    """Keys wholly after every query under a causal mask leave o, m and l
    exactly as they came in, also in rows that have seen no key yet."""
    _need_card()
    bh, s, d = 3, 40, 16
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, o = (torch.randn((bh, s, d), generator=g, device="cuda")
                  for _ in range(4))
    m = torch.randn((bh, s), generator=g, device="cuda")
    l = torch.rand((bh, s), generator=g, device="cuda")
    m[0], l[0], o[0] = FA.NEG_INF, 0.0, 0.0
    o2, m2, l2 = FA.flash_attention_carry(q, k, v, o, m, l, q_offset=0,
                                          kv_offset=s, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o2, o) and torch.equal(m2, m) and torch.equal(l2, l)


def test_flash_attention_autograd_on_card_matches_cpu(monkeypatch):
    """The differentiable entry on the card (K2 + K3, non-contiguous
    (B, S, H, D)-transposed inputs as the LM gives them) against the same
    entry on the CPU (the plain versions)."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rs = np.random.RandomState(3)
    x = [rs.normal(size=(2, 50, 4, 32)).astype(np.float32) for _ in range(3)]
    res = {}
    for dev in ("cuda", "cpu"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in x]
        out = FA.flash_attention(*[t.transpose(1, 2) for t in ts],
                                 causal=True)
        (out ** 2).sum().backward()
        res[dev] = [out.detach().cpu()] + [t.grad.cpu() for t in ts]
    for a, b in zip(res["cuda"], res["cpu"]):
        _close(a, b, 1e-4)


def test_flash_wrappers_raise_instead_of_falling_back():
    """CUDA tensors the kernels do not take raise; nothing runs the plain
    version for them."""
    _need_card()
    bh, s, d = 2, 16, 8
    q = torch.randn((bh, s, d), device="cuda")
    o, m, l = (torch.zeros((bh, s, d), device="cuda"),
               torch.zeros((bh, s), device="cuda"),
               torch.zeros((bh, s), device="cuda"))
    before = (FA.fwd_launches, FA.bwd_launches)
    nc = torch.randn((bh, d, s), device="cuda").transpose(1, 2)
    with pytest.raises(mt.MXNetError, match="contiguous"):
        FA.flash_attention_carry(nc, q, q, o, m, l)
    with pytest.raises(mt.MXNetError, match="contiguous"):
        FA.flash_attention_bwd(q, q, q, nc, m, l)
    with pytest.raises(mt.MXNetError, match="dtype"):
        FA.flash_attention_carry(q.half(), q.half(), q.half(), o, m, l)
    with pytest.raises(mt.MXNetError, match="head dim"):
        big = torch.zeros((1, 4, 160), device="cuda")
        FA.flash_attention_carry(big, big, big, big,
                                 torch.zeros((1, 4), device="cuda"),
                                 torch.zeros((1, 4), device="cuda"))
    assert (FA.fwd_launches, FA.bwd_launches) == before


def test_lm_trains_on_card_through_both_routes(monkeypatch):
    """Three SPMDTrainer steps of a small causal-attention LM on gpu(0):
    K2 once per step on the ring route, K2 and K3 once per step on the
    Ulysses route; losses finite and equal to the port's CPU run."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from mxnet_tpu_torch import parallel
    vocab, embed, heads, batch, seq = 64, 32, 4, 2, 16
    d = embed // heads
    rng = np.random.RandomState(0)
    params = {n: rng.normal(0, 0.02, s).astype(np.float32) for n, s in (
        ("embed", (vocab, embed)), ("wq", (embed, embed)),
        ("wk", (embed, embed)), ("wv", (embed, embed)),
        ("wo", (embed, embed)), ("w1", (4 * embed, embed)),
        ("w2", (embed, 4 * embed)), ("head", (vocab, embed)))}
    xs = [np.random.RandomState(i).randint(0, vocab, (batch, seq))
          for i in range(6)]

    def split(t):
        return t.reshape(batch, seq, heads, d).permute(0, 2, 1, 3)

    def run(fn, ctx):
        mesh = parallel.make_mesh({"dp": 1, "sp": 1}, devices=[ctx])

        def apply_fn(p, x, y):
            e = p["embed"][x.long()]
            a = fn(split(e @ p["wq"].T), split(e @ p["wk"].T),
                   split(e @ p["wv"].T), mesh, causal=True)
            h = e + a.permute(0, 2, 1, 3).reshape(batch, seq, embed) \
                @ p["wo"].T
            h = h + torch.relu(h @ p["w1"].T) @ p["w2"].T
            logp = torch.log_softmax(h @ p["head"].T, dim=-1)
            return (-logp.gather(-1, y.long()[..., None])).mean()
        tr = parallel.SPMDTrainer(apply_fn, params, mesh, learning_rate=0.1,
                                  momentum=0.9)
        return [float(tr.step(xs[2 * i], xs[2 * i + 1])) for i in range(3)]

    for fn, bwd_per_step in ((parallel.ring_attention, 0),
                             (parallel.ulysses_attention, 1)):
        before = (FA.fwd_launches, FA.bwd_launches)
        on_card = run(fn, mt.gpu(0))
        assert (FA.fwd_launches - before[0],
                FA.bwd_launches - before[1]) == (3, 3 * bwd_per_step)
        assert np.isfinite(on_card).all()
        np.testing.assert_allclose(on_card, run(fn, mt.cpu()), rtol=1e-5,
                                   atol=1e-6)


# -- continuous-batching decode ---------------------------------------------

DECODE_PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3],
                  [2, 7])


def _decode_cell(kind):
    from mxnet_tpu_torch.decode import AttentionDecodeCell, LSTMDecodeCell
    if kind == "attn":
        return AttentionDecodeCell(vocab=29, embed=16, heads=4, head_dim=8,
                                   max_len=48)
    return LSTMDecodeCell(vocab=23, embed=8, hidden=16, max_len=32)


def _decode_engine(cell, ctx, **kw):
    from mxnet_tpu_torch.decode import DecodeEngine
    return DecodeEngine(cell, cell.init_params(1), slots=4,
                        max_prompt_len=16, max_new_tokens=10,
                        keep_logits=True, ctx=ctx, **kw)


@pytest.mark.parametrize("kind", ["attn", "lstm"])
def test_decode_engine_on_card_matches_cpu(kind, monkeypatch):
    """The small engine on gpu(0), one at a time and all at once, gives
    the port's CPU tokens; logits within 1e-5 of the largest |logit|."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cell = _decode_cell(kind)
    prompts = [np.array(p, np.int32) for p in DECODE_PROMPTS]
    runs = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        with _decode_engine(cell, ctx) as eng:
            serial = [eng.generate(p) for p in prompts]
            futs = [eng.submit(p) for p in prompts]
            runs[ctx.device_type] = serial + [f.result(timeout=120)
                                              for f in futs]
    for got, want in zip(runs["gpu"], runs["cpu"]):
        assert got.tokens == want.tokens
        np.testing.assert_allclose(got.logits, want.logits, rtol=0,
                                   atol=1e-5 * np.abs(want.logits).max())


def test_decode_padding_lanes_write_nothing_on_card():
    """A bucket-4 step with two live lanes (slots 2 and 0) and two padding
    lanes: slots 1 and 3 stay byte-identical, the live slots change only
    at their own positions."""
    _need_card()
    with _decode_engine(_decode_cell("attn"), mt.gpu(0)) as eng:
        g = torch.Generator(device="cuda").manual_seed(0)
        for leaf in eng._cache.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g, device="cuda"))
        before = {n: t.clone() for n, t in eng._cache.items()}
        pos = np.array([7, 30, 0, 0], np.int32)
        eng._decode_prog(eng._params, eng._cache,
                         np.array([2, 0, 4, 4], np.int32),
                         np.array([5, 6, 0, 0], np.int32), pos)
        torch.cuda.synchronize()
        for n, t in eng._cache.items():
            for slot in (1, 3):
                assert torch.equal(t[slot], before[n][slot]), (n, slot)
            for slot, p in ((2, 7), (0, 30)):
                changed = (t[slot] != before[n][slot]).any(-1).any(0)
                assert changed.nonzero().flatten().tolist() == [p], (n, slot)


def test_decode_steady_state_allocates_no_segment():
    """After warmup the pool is zero, and traffic over every prompt and
    slot bucket opens no new CUDA allocator segment."""
    _need_card()
    with _decode_engine(_decode_cell("attn"), mt.gpu(0)) as eng:
        assert all(not t.any() for t in eng._cache.values())
        segs = torch.cuda.memory_stats()["segment.all.allocated"]
        prompts = [np.arange(1, n + 1, dtype=np.int32) % 29
                   for n in (1, 2, 3, 5, 9, 16)]
        for k in (1, 2, 3, 4, 6):
            futs = [eng.submit(p) for p in prompts[:k]]
            assert all(f.result(timeout=120).tokens for f in futs)
        assert torch.cuda.memory_stats()["segment.all.allocated"] == segs


# -- the Gluon loop: NDArray tape, hybridize, gluon.loss, gluon.Trainer ------

def _small_gluon_net(ctx):
    mt.layout.set_default_layout("NHWC")
    try:
        with mt.name.NameManager():
            net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                  [8, 16, 32, 64, 128], classes=10,
                                  thumbnail=True)
    finally:
        mt.layout.set_default_layout(None)
    net.initialize(mt.init.Xavier(generator=torch.Generator().manual_seed(0)),
                   ctx=ctx)
    net(mt.nd.zeros((1, 32, 32, 3), ctx=ctx))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_gluon_step1_on_card_matches_raw_step(hybridize, monkeypatch):
    """Step 1 of README.md's loop on the card (record, SoftmaxCELoss,
    backward, Trainer.step) against the raw step (make_pure_fn +
    torch.autograd + FusedUpdater) on the same weights and batch, TF32
    off, cudnn deterministic: loss within 1e-5 relative, parameters within
    1e-4 of each tensor's largest value; 4 K1 launches per forward."""
    _need_card()
    monkeypatch.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    from mxnet_tpu_torch.gluon.block import make_pure_fn
    ctx = mt.gpu(0)
    net = _small_gluon_net(ctx)
    params = net.collect_params()
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    y = rs.randint(0, 10, 8)
    X, Y = mt.nd.array(x, ctx=ctx), mt.nd.array(y, ctx=ctx)
    # the raw step
    fn, raw, _ = make_pure_fn(net, train=True)
    w = [mt.nd.NDArray(r.detach().clone()) for r in raw]
    live = [i for i, p in enumerate(params.values()) if p.grad_req != "null"]
    full = [t._data.detach().requires_grad_() for t in w]
    (logits,), aux = fn(full, [X._data])
    loss = -torch.log_softmax(logits, -1).gather(
        1, torch.from_numpy(y).cuda()[:, None]).mean()
    grads = torch.autograd.grad(loss, [full[i] for i in live])
    upd = mt.optimizer.get_updater(mt.optimizer.SGD(learning_rate=0.05,
                                                    momentum=0.9))
    upd.update_batch(live, [mt.nd.NDArray(g) for g in grads],
                     [w[i] for i in live])
    with torch.no_grad():
        for i, v in aux.items():
            w[i]._data.copy_(v)
    # the Gluon step
    net.hybridize(hybridize)
    tr = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                          "momentum": 0.9})
    before = K.launches
    with mt.autograd.record():
        l = mt.gluon.loss.SoftmaxCrossEntropyLoss()(net(X), Y)
    l.backward()
    tr.step(8)
    torch.cuda.synchronize()
    assert K.launches == before + 4
    np.testing.assert_allclose(float(l.mean().asscalar()), float(loss.detach()),
                               rtol=1e-5)
    for (name, p), ref in zip(params.items(), w):
        got, want = p.data().asnumpy(), ref.asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(
            np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_tape_grad_req_on_card(req):
    """``grad_req`` write overwrites, add accumulates, null leaves the
    buffer, on CUDA tensors; an op outside ``record`` builds no graph;
    a second backward without ``retain_graph`` raises."""
    _need_card()
    ctx = mt.gpu(0)
    x = mt.nd.array(np.array([1.0, -2.0, 3.0], np.float32), ctx=ctx)
    g = mt.nd.array(np.full(3, 7.0, np.float32), ctx=ctx)
    mt.autograd.mark_variables([x], [g], req)
    for _ in range(2):
        with mt.autograd.record():
            y = (x * x * 3).sum()
        y.backward()
    assert g._data.is_cuda
    want = {"write": 6 * x.asnumpy(), "add": 7 + 12 * x.asnumpy(),
            "null": np.full(3, 7.0)}[req]
    np.testing.assert_allclose(g.asnumpy(), want, rtol=1e-6)
    assert not (x * 2)._data.requires_grad
    with pytest.raises(mt.MXNetError):
        y.backward()


# ---------------------------------------------------------------------------
# The recurrent family (slice 7): cuDNN's fused RNN, Dropout, the samplers
# and BucketingModule on the card against the port on the CPU
# ---------------------------------------------------------------------------

def _rnn_param_size(i, h, layers, mode, bi):
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    return rnn_param_size(i, h, layers, mode, bi)


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_on_card_matches_cpu(mode, bidirectional, monkeypatch):
    """The fused RNN op through cuDNN (2 layers, TF32 off) against ATen's
    CPU loop: outputs, states and gradients within 1e-5 of the largest;
    1e-4 in ``rnn_tanh`` mode, whose tanh in cuDNN differs from ATen's
    CPU tanh by up to 3e-5 relative (measured on an H100, where the
    other modes agree within 1e-5)."""
    _need_card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rs = np.random.RandomState(0)
    d = 2 if bidirectional else 1
    arrs = [rs.randn(7, 4, 5), 0.3 * rs.randn(_rnn_param_size(
        5, 6, 2, mode, bidirectional)), rs.randn(2 * d, 4, 6),
            rs.randn(2 * d, 4, 6)]
    arrs = [a.astype(np.float32) for a in arrs[:4 if mode == "lstm" else 3]]
    res = []
    for ctx in (mt.gpu(0), mt.cpu()):
        xs = [mt.nd.array(a, ctx=ctx) for a in arrs]
        for x in xs:
            x.attach_grad()
        with mt.autograd.record():
            outs = mt.nd.RNN(*xs, state_size=6, num_layers=2, mode=mode,
                             bidirectional=bidirectional, state_outputs=True)
            loss = sum((o * o).sum() for o in outs)
        loss.backward()
        res.append([o.asnumpy() for o in outs] +
                   [x.grad.asnumpy() for x in xs])
    tol = 1e-4 if mode == "rnn_tanh" else 1e-5
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * np.abs(b).max())


def test_gluon_lstm_on_card_runs_cudnn_and_hybridized_equals_eager(
        monkeypatch):
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    gpu = mt.gpu(0)
    net = mt.gluon.rnn.LSTM(32, 2, input_size=16)
    net.initialize(mt.init.Xavier(generator=torch.Generator().manual_seed(0)),
                   ctx=gpu)
    x = mt.nd.array(np.random.RandomState(1).randn(9, 4, 16), ctx=gpu)
    outs = []
    for hyb in (False, True):
        net.hybridize(hyb)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with mt.autograd.record():
                out, states = net(x, net.begin_state(4))
            out.backward()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()}
        assert counts.get("aten::_cudnn_rnn", 0) == 2, counts
        outs.append((out.asnumpy(), [s.asnumpy() for s in states],
                     {k: p.grad().asnumpy().copy()
                      for k, p in net.collect_params().items()}))
    (eo, es, eg), (ho, hs, hg) = outs
    np.testing.assert_array_equal(ho, eo)
    for a, b in zip(hs, es):
        np.testing.assert_array_equal(a, b)
    for k in eg:
        np.testing.assert_array_equal(hg[k], eg[k])


def test_dropout_and_samplers_on_card():
    _need_card()
    gpu = mt.gpu(0)
    x = mt.nd.ones((300, 300), ctx=gpu)
    mt.random.seed(4)
    with mt.autograd.record():
        a = mt.nd.Dropout(x, p=0.3).asnumpy()
    mt.random.seed(4)
    with mt.autograd.record():
        b = mt.nd.Dropout(x, p=0.3).asnumpy()
    np.testing.assert_array_equal(a, b)
    kept = (a != 0).mean()
    assert abs(kept - 0.7) <= 4 * np.sqrt(0.21 / a.size)
    np.testing.assert_allclose(np.unique(a[a != 0]), 1 / 0.7, rtol=1e-6)
    u = mt.nd.random.uniform(-1, 3, shape=(400, 400), ctx=gpu)
    assert u.context == gpu and u.shape == (400, 400)
    assert abs(float(u.asnumpy().mean()) - 1.0) < 0.02
    n = mt.nd.random.normal(2, 0.5, shape=(400, 400), ctx=gpu).asnumpy()
    assert abs(n.mean() - 2) < 0.01 and abs(n.std() - 0.5) < 0.01


def test_bucketing_module_on_card_matches_cpu(monkeypatch):
    """A small bucketing LSTM (2 buckets, Adam) fitted on the card and on
    the CPU from the same weights: parameters within 1e-4 of each tensor's
    largest magnitude, Perplexity within 1e-4 relative."""
    _need_card()
    import random
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    vocab, hidden = 30, 16

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data=data, input_dim=vocab, output_dim=8,
                                 name="embed")
        stack = mt.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(mt.rnn.LSTMCell(num_hidden=hidden,
                                      prefix="lstm_l%d_" % i))
        out, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.FullyConnected(mt.sym.Reshape(out, shape=(-1, hidden)),
                                     num_hidden=vocab, name="pred")
        pred = mt.sym.SoftmaxOutput(pred, mt.sym.Reshape(label, shape=(-1,)),
                                    use_ignore=True, ignore_label=-1,
                                    name="softmax")
        return pred, ("data",), ("softmax_label",)

    rng = np.random.RandomState(0)
    sents = []
    for _ in range(64):
        n, s = rng.randint(5, 20), rng.randint(0, vocab)
        sents.append([(s + t) % vocab for t in range(n)])
    init, results = None, []
    for ctx in (mt.gpu(0), mt.cpu()):
        random.seed(1)
        np.random.seed(1)
        it = mt.rnn.BucketSentenceIter(sents, 8, buckets=[10, 20])
        mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=20,
                                     context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        if init is None:
            mod.init_params(mt.init.Xavier(
                generator=torch.Generator().manual_seed(0)))
            init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            mod.init_params(arg_params=init, aux_params={})
        mod.init_optimizer(optimizer="adam", optimizer_params={
            "learning_rate": 0.01, "rescale_grad": 1 / 8})
        random.seed(2)
        np.random.seed(2)
        met = mt.metric.Perplexity(ignore_label=-1)
        mod.fit(it, eval_metric=met, num_epoch=2)
        results.append(({k: v.asnumpy()
                         for k, v in mod.get_params()[0].items()},
                        met.get()[1]))
    (gp, gppl), (cp, cppl) = results
    assert abs(gppl - cppl) <= 1e-4 * cppl
    for k in cp:
        assert np.abs(gp[k] - cp[k]).max() <= 1e-4 * np.abs(cp[k]).max(), k


# ---------------------------------------------------------------------------
# image classification beyond ResNet: LRN, the store, pinned batches, the
# model zoo
# ---------------------------------------------------------------------------

def _no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def test_lrn_on_card_matches_cpu():
    _need_card()
    x = np.random.RandomState(0).randn(4, 96, 13, 13).astype(np.float32)
    outs = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        a = mt.nd.array(x, ctx=ctx)
        a.attach_grad()
        with mt.autograd.record():
            y = mt.nd.LRN(a, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
        y.backward()
        outs[ctx.device_type] = (y.asnumpy(), a.grad.asnumpy())
    for g, c in zip(outs["gpu"], outs["cpu"]):
        assert np.abs(g - c).max() <= 1e-5 * np.abs(c).max()


def test_store_push_pull_on_card_matches_cpu():
    _need_card()
    rs = np.random.RandomState(1)
    w, g1, g2 = (rs.randn(64, 33).astype(np.float32) for _ in range(3))
    got = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        kv = mt.kvstore.create("device")
        kv.init("w", mt.nd.array(w, ctx=ctx))
        kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9, wd=1e-4))
        for _ in range(3):
            kv.push("w", [mt.nd.array(g1, ctx=ctx),
                          mt.nd.array(g2, ctx=ctx)])
        out = mt.nd.zeros((64, 33), ctx=ctx)
        kv.pull("w", out=out)
        assert kv._store["w"].context == ctx
        got[ctx.device_type] = out.asnumpy()
    np.testing.assert_allclose(got["gpu"], got["cpu"], rtol=1e-6,
                               atol=1e-6)


def test_dataloader_pinned_batches_copy_to_the_card():
    _need_card()
    x = np.random.RandomState(2).randn(20, 3, 8, 8).astype(np.float32)
    y = np.arange(20, dtype=np.float32)
    ds = mt.gluon.data.ArrayDataset(x, y)
    plain = list(mt.gluon.data.DataLoader(ds, batch_size=6))
    pinned = list(mt.gluon.data.DataLoader(ds, batch_size=6,
                                           pin_memory=True, num_workers=2))
    for (pa, pb), (qa, qb) in zip(plain, pinned):
        assert qa._data.is_pinned() and qb._data.is_pinned()
        dev = qa.as_in_context(mt.gpu(0))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(dev.asnumpy(), pa.asnumpy())
        np.testing.assert_array_equal(qb.asnumpy(), pb.asnumpy())


@pytest.mark.parametrize("name,hw", [("densenet121", 64),
                                     ("squeezenet1.0", 64),
                                     ("mobilenet0.5", 64)])
def test_zoo_forward_on_card_matches_cpu(name, hw, monkeypatch):
    _need_card()
    _no_tf32(monkeypatch)
    x = np.random.RandomState(3).uniform(-1, 1, (2, 3, hw, hw)) \
        .astype(np.float32)
    nets = {}
    for ctx in (mt.cpu(), mt.gpu(0)):
        net = mt.gluon.model_zoo.vision.get_model(name, classes=10,
                                                  prefix="zoo_")
        net.initialize(mt.init.Xavier(
            generator=torch.Generator().manual_seed(0)), ctx=ctx)
        net(mt.nd.array(x, ctx=ctx))
        nets[ctx.device_type] = net
    for k, p in nets["cpu"].collect_params().items():
        nets["gpu"].collect_params()[k].set_data(
            mt.nd.array(p.data().asnumpy(), ctx=mt.gpu(0)))
    want = nets["cpu"](mt.nd.array(x, ctx=mt.cpu())).asnumpy()
    got = nets["gpu"](mt.nd.array(x, ctx=mt.gpu(0))).asnumpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# -- the instruments (cards, faults, the profiler) on the card --------------

def _fused_resnet_engine(monkeypatch, max_batch=4):
    """A narrow fused-tail ResNet v1 (NHWC, 4 K1 tails) served on the
    card."""
    monkeypatch.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
    mt.layout.set_default_layout("NHWC")
    try:
        with mt.name.NameManager():
            net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                  [16, 32, 64, 128, 256], classes=10)
        net.initialize(mt.init.Xavier(
            generator=torch.Generator().manual_seed(0)), ctx=mt.gpu(0))
        net(mt.nd.zeros((1, 32, 32, 3), ctx=mt.gpu(0)))
        with mt.name.NameManager():
            sym = net(mt.sym.Variable("data"))
        params = {"arg:" + k: p.data() for k, p in
                  net.collect_params().items()
                  if not k.endswith(("running_mean", "running_var"))}
        params.update({"aux:" + k: p.data() for k, p in
                       net.collect_params().items()
                       if k.endswith(("running_mean", "running_var"))})
        return mt.serving.InferenceEngine(sym, params,
                                          {"data": (1, 32, 32, 3)},
                                          max_batch=max_batch,
                                          ctx=mt.gpu(0))
    finally:
        mt.layout.set_default_layout(None)


def test_program_cards_on_the_card(monkeypatch):
    """Bucket cards carry the allocator's peak on the card; K1 (ctypes)
    adds no FLOPs, so the card's FLOPs scale exactly with the bucket."""
    _need_card()
    from mxnet_tpu_torch import telemetry
    telemetry.enable()
    telemetry.reset()
    with _fused_resnet_engine(monkeypatch) as eng:
        cards = eng.program_cards()
        by_b = {next(e for e in c["signature"] if "'data'" in e[0])[1][0]: c
                for c in cards.values()}
        assert sorted(by_b) == [1, 2, 4]
        for b, c in by_b.items():
            assert c["peak_bytes"] and c["peak_bytes"] > 0
            assert c["dispatches"] == 0
            assert c["flops"] == by_b[1]["flops"] * b
        out = eng.predict(data=np.ones((3, 32, 32, 3), np.float32))[0]
        assert np.isfinite(out).all()
        assert eng.device_bytes()["total"] > 0


def test_dispatch_nan_fills_cuda_outputs(monkeypatch):
    _need_card()
    from mxnet_tpu_torch import faults
    with _fused_resnet_engine(monkeypatch) as eng:
        faults.configure("dispatch:nan:n=1")
        try:
            bad = eng.predict(data=np.ones((2, 32, 32, 3), np.float32))[0]
            good = eng.predict(data=np.ones((2, 32, 32, 3), np.float32))[0]
        finally:
            faults.clear()
    assert np.isnan(bad).all() and np.isfinite(good).all()


def test_profiler_merges_cuda_kernels_and_host_spans(tmp_path, monkeypatch):
    """One JSON with the K1 kernels and the host ``serve_batch`` spans on
    one timebase: each span encloses the start of a K1 kernel it
    launched."""
    _need_card()
    import json
    from mxnet_tpu_torch import telemetry
    telemetry.enable()
    fname = str(tmp_path / "profile.json")
    with _fused_resnet_engine(monkeypatch) as eng:
        mt.profiler.set_config(filename=fname)
        mt.profiler.set_state("run")
        for _ in range(3):
            eng.predict(data=np.ones((4, 32, 32, 3), np.float32))
        mt.profiler.set_state("stop")
    with open(fname) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "scale_bias_add_relu" in e.get("name", "")]
    spans = [e for e in events if e.get("cat") == "host"
             and e["name"] == "serve_batch"]
    assert len(k1) >= 12 and len(spans) == 3
    for s in spans:
        assert any(s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for e in k1)


# ---------------------------------------------------------------------------
# dense prediction and the Module toolbox: the new ops, optimizers, the
# narrow FCN through fit with preemption and resume
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_card", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD_OPS = [
    ("Deconvolution", [(2, 8, 6, 6), (8, 4, 4, 4)],
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=8,
          num_group=2)),
    ("Deconvolution", [(1, 5, 3, 3), (5, 5, 32, 32)],
     dict(kernel=(32, 32), stride=(16, 16), num_filter=5)),
    ("Crop", [(2, 3, 26, 26), (2, 3, 24, 24)], dict(offset=(1, 1),
                                                    num_args=2)),
    ("UpSampling", [(2, 3, 5, 5), (3, 1, 4, 4)],
     dict(scale=2, sample_type="bilinear", num_filter=3, num_args=2)),
    ("InstanceNorm", [(2, 4, 6, 6), (4,), (4,)], {}),
    ("LayerNorm", [(4, 6, 8), (8,), (8,)], {}),
    ("LeakyReLU", [(4, 6), (6,)], dict(act_type="prelu")),
    ("L2Normalization", [(3, 4, 5)], dict(mode="channel")),
    ("linalg_potrf", None, {}),
    ("linalg_trsm", None, dict(rightside=True, alpha=0.5)),
]


@pytest.mark.parametrize("op,shapes,kw", _CARD_OPS,
                         ids=["%s%d" % (c[0], i)
                              for i, c in enumerate(_CARD_OPS)])
def test_new_op_on_card_matches_cpu(op, shapes, kw, monkeypatch):
    _need_card()
    _no_tf32(monkeypatch)
    rs = np.random.RandomState(4)
    if shapes is None:          # a lower triangle with a positive diagonal
        m = rs.uniform(-1, 1, (5, 5)).astype(np.float32)
        spd = m @ m.T + 5 * np.eye(5, dtype=np.float32)
        arrays = [spd] if op == "linalg_potrf" else \
            [np.linalg.cholesky(spd).astype(np.float32),
             rs.uniform(-1, 1, (3, 5)).astype(np.float32)]
    else:
        arrays = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    outs = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        nds = [mt.nd.array(a, ctx=ctx) for a in arrays]
        nds[0].attach_grad()
        with mt.autograd.record():
            y = getattr(mt.nd, op)(*nds, **kw)
        head = np.random.RandomState(6).uniform(-1, 1, y.shape)
        y.backward(mt.nd.array(head.astype(np.float32), ctx=ctx))
        outs[ctx.device_type] = (y.asnumpy(), nds[0].grad.asnumpy())
    for g, c in zip(outs["gpu"], outs["cpu"]):
        assert np.abs(g - c).max() <= 1e-5 * np.abs(c).max()


@pytest.mark.parametrize("name,kw", [
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("adagrad", dict(learning_rate=0.1)), ("adadelta", dict(rho=0.8)),
    ("ftrl", dict(learning_rate=0.2)), ("adamax", dict()),
    ("nadam", dict()), ("dcasgd", dict(momentum=0.9)),
])
def test_optimizer_on_card_matches_cpu(name, kw):
    """Three updates through ``FusedUpdater.update_batch`` (the kernel
    where the optimizer has one) on the card and on the CPU."""
    _need_card()
    rs = np.random.RandomState(5)
    w0 = [rs.uniform(-1, 1, s).astype(np.float32) for s in ((33, 7), (7,))]
    gs = [[rs.uniform(-1, 1, w.shape).astype(np.float32) for w in w0]
          for _ in range(3)]
    got = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        opt = mt.optimizer.create(name, wd=1e-3, param_idx2name={
            0: "a_weight", 1: "a_bias"}, **kw)
        upd = mt.optimizer.get_updater(opt)
        ws = [mt.nd.array(w, ctx=ctx) for w in w0]
        for g in gs:
            upd.update_batch([0, 1], [mt.nd.array(x, ctx=ctx) for x in g],
                             ws)
        got[ctx.device_type] = [w.asnumpy() for w in ws]
    for g, c in zip(got["gpu"], got["cpu"]):
        np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-6)


def test_fcn_fit_preempt_resume_on_card(tmp_path, monkeypatch):
    """The narrow FCN-16s through ``fit`` on the card: within 1e-4 of
    the CPU's parameters after 3 batches; preempted at epoch 1 batch 2
    and resumed (Dropout 0.5 on the card's generator), bit-equal to the
    uninterrupted run."""
    _need_card()
    _no_tf32(monkeypatch)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cs = _chip_smoke()
    cfg = cs._FCN[True]
    x, y = cs.fcn_data(cs._FCN_SEED, 6, cfg["hw"], cfg["classes"])

    def sym(p):
        return cs.fcn16s_symbol(mt, cfg["classes"], cfg["widths"],
                                cfg["fc"], p=p)
    init = mt.mod.Module(sym(0.0), context=mt.cpu())
    init.bind([("data", (2, 3, 64, 64))], [("softmax_label", (2, 64, 64))])
    init.init_params(cs.fcn_init(mt))
    arg0 = cs._host_params(init)[0]

    def fit(ctx, p, epochs, **kw):
        it = mt.io.NDArrayIter(x, y, batch_size=2, shuffle=False)
        return cs._fcn_fit(mt, sym(p), ctx, arg0, it, epochs, **kw)
    card = cs._host_params(fit(mt.gpu(0), 0.0, 1))[0]
    cpu = cs._host_params(fit(mt.cpu(), 0.0, 1))[0]
    assert cs._max_scaled(card, cpu) <= 1e-4
    mt.random.seed(3)
    ref = fit(mt.gpu(0), 0.5, 2)
    mgr = mt.CheckpointManager(str(tmp_path / "p"), keep_last=2)

    def preempt(param):
        if (param.epoch, param.nbatch) == (1, 1):
            mgr.request_preempt("SIGTERM")
    mt.random.seed(3)
    with pytest.raises(mt.checkpoint.TrainingPreempted):
        fit(mt.gpu(0), 0.5, 2, checkpoint=mgr, batch_end_callback=preempt)
    mt.random.seed(4)
    res = fit(mt.gpu(0), 0.5, 2, resume=True,
              checkpoint=mt.CheckpointManager(mgr.prefix, keep_last=2))
    assert cs._bit_equal(cs._host_params(res)[0], cs._host_params(ref)[0])


def test_monitor_and_finite_check_on_card():
    _need_card()
    data = mt.sym.Variable("data")
    out = mt.sym.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                               num_filter=3, name="up")
    exe = out.simple_bind(ctx=mt.gpu(0), data=(1, 2, 4, 4))
    mon = mt.mon.Monitor(1, pattern="up.*")
    mon.install(exe)
    exe.arg_dict["data"][:] = 1.0
    exe.arg_dict["up_weight"][:] = 0.5
    mon.tic()
    exe.forward()
    rows = mon.toc()
    assert [r[1] for r in rows] == ["up_output", "up_weight"]
    assert float(rows[1][2]) == 0.5


# -- data parallelism across worker processes (slice 11) ----------------------

_DP_WORKER = r'''
import hashlib, json, os, sys
import numpy as np
import torch
import mxnet_tpu_torch as mt

out = sys.argv[1]
rank = mt.dist.rank()
ctx = mt.gpu(0)
g = mt.parallel.collectives.all_gather(torch.full((3,), float(rank),
                                                  device="cuda"))
res = {"backend": mt.dist.backend(), "gathered": g.tolist(),
       "gathered_on": str(g.device)}
data = mt.sym.Variable("data")
net = mt.sym.FullyConnected(data, num_hidden=16, name="fc1")
net = mt.sym.Activation(net, act_type="relu")
net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
sym = mt.sym.SoftmaxOutput(net, mt.sym.Variable("softmax_label"),
                           name="softmax")
rs = np.random.RandomState(rank)
x = rs.randn(16, 8).astype(np.float32)
y = rs.randint(0, 4, 16).astype(np.float32)
for name, comp in (("sync", None), ("2bit", {"type": "2bit",
                                             "threshold": 0.5})):
    mod = mt.mod.Module(sym, context=ctx, compression_params=comp)
    mod.bind(data_shapes=[("data", (8, 8))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(mt.init.Xavier(rnd_type="gaussian"))
    mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1)
    arg = mod.get_params()[0]
    h = hashlib.sha256()
    for k in sorted(arg):
        h.update(arg[k].asnumpy().tobytes())
    res[name] = {"digest": h.hexdigest(),
                 "wire": mod._kvstore.wire_bytes_last_push,
                 "raw": mod._kvstore.wire_bytes_last_push_raw,
                 "on": str(arg["fc1_weight"]._data.device)}
with open(os.path.join(out, "r%d.json" % rank), "w") as f:
    json.dump(res, f)
mt.dist.finalize()
'''


def test_two_workers_on_one_card_bit_equal_and_compressed_wire(tmp_path):
    """Two workers on ``cuda:0`` (the launcher's own rule: fewer cards
    than workers, so they share it over gloo): a CUDA all-gather staged
    through the host, ``dist_sync`` fits with bit-equal replicas, and the
    2-bit wire at ``ceil(n/16)`` words per key."""
    _need_card()
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_DP_WORKER)
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.launch",
                          "-n", "2", "--timeout", "150", "--",
                          sys.executable, str(script), str(tmp_path)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    r0, r1 = (json.loads((tmp_path / ("r%d.json" % r)).read_text())
              for r in range(2))
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["gathered"] == [0.0] * 3 + [1.0] * 3
    assert r0["gathered_on"].startswith("cuda")
    sizes = [16 * 8, 16, 4 * 16, 4]
    for name in ("sync", "2bit"):
        assert r0[name]["digest"] == r1[name]["digest"], name
        assert r0[name]["on"].startswith("cuda")
    assert r0["sync"]["wire"] == r0["sync"]["raw"] == 4 * sum(sizes)
    assert r0["2bit"]["raw"] == 4 * sum(sizes)
    assert r0["2bit"]["wire"] == 4 * sum(-(-n // 16) for n in sizes)


def test_module_on_one_card_twice_raises():
    """``[gpu(0), gpu(0)]`` names one device twice: the JAX package
    refuses such a context list (``parallel/mesh.py:59-62``) and so does
    the port."""
    _need_card()
    data = mt.sym.Variable("data")
    sym = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(data, num_hidden=2),
                               name="softmax")
    with pytest.raises(mt.MXNetError, match="duplicate devices"):
        mt.mod.Module(sym, context=[mt.gpu(0), mt.gpu(0)])


# -- sequence parallelism across worker processes (slice 12) ------------------

def test_k2_leaves_the_carry_alone_on_a_fully_masked_block():
    """Ring attention's causal steps bring blocks whose keys all lie
    after the queries (``kv_offset`` >= ``q_offset`` + S): K2 must hand
    the running ``(o, m, l)`` back unchanged, whether ``m`` is already
    finite (the own block came first) or still the empty carry."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    bh, s, d = 6, 128, 64
    q, k, v = (torch.randn(bh, s, d, generator=g, device="cuda")
               for _ in range(3))
    o0 = torch.zeros(bh, s, d, device="cuda")
    m0 = torch.full((bh, s), FA.NEG_INF, device="cuda")
    l0 = torch.zeros(bh, s, device="cuda")
    # the own block first: a finite carry
    o, m, l = FA.flash_attention_carry(q, k, v, o0, m0, l0, q_offset=s,
                                       kv_offset=s, causal=True)
    for carry in ((o, m, l), (o0, m0, l0)):
        before = FA.fwd_launches
        got = FA.flash_attention_carry(q, k, v, *carry, q_offset=s,
                                       kv_offset=2 * s, causal=True)
        torch.cuda.synchronize()
        assert FA.fwd_launches == before + 1
        want = FA.flash_attention_carry_reference(
            q.cpu(), k.cpu(), v.cpu(), *(t.cpu() for t in carry),
            q_offset=s, kv_offset=2 * s, causal=True)
        for a, b, c in zip(got, carry, want):
            assert torch.equal(a, b)
            assert torch.equal(a.cpu(), c)


_RING_WORKER = r'''
import json, os, sys
import numpy as np
import torch
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import flash_attention as FA

out = sys.argv[1]
rank = mt.dist.rank()
torch.backends.cuda.matmul.allow_tf32 = False
mesh = mt.parallel.make_mesh({"sp": 2}, devices=[mt.gpu(0)])
rs = np.random.RandomState(0)
whole = [rs.randn(2, 4, 256, 64).astype(np.float32) for _ in range(4)]
pl = mt.parallel.Placement(mesh, mt.parallel.P(None, None, "sp", None))
res = {}
for causal in (True, False):
    got = {}
    for route in (True, False):
        q, k, v = (mt.parallel.shard_put(a, pl).requires_grad_()
                   for a in whole[:3])
        w = mt.parallel.shard_put(whole[3], pl)
        FA.fwd_launches = 0
        o = mt.parallel.ring_attention(q, k, v, mesh, causal=causal,
                                       use_pallas=route)
        launches = FA.fwd_launches
        grads = torch.autograd.grad((o * w).sum(), [q, k, v])
        got[route] = [o.detach()] + list(grads)
        res["launches_%d_%d" % (causal, route)] = launches
    res["err_%d" % causal] = max(
        float((a - b).abs().max() / b.abs().max())
        for a, b in zip(got[True], got[False]))
    np.save(os.path.join(out, "ring_%d_r%d.npy" % (causal, rank)),
            got[True][0].cpu().numpy())
with open(os.path.join(out, "r%d.json" % rank), "w") as f:
    json.dump(res, f)
mt.dist.finalize()
'''


def test_ring_across_two_workers_kernel_against_plain_ring(tmp_path):
    """Two workers on ``cuda:0`` each hold half of the sequence: ring
    attention through K2 (one launch per ring step, two here) against the
    plain ring on the same blocks, forward and q/k/v gradients, causal
    (the second step's block is fully masked on rank 0) and not; the
    joined outputs against plain attention over the whole sequence."""
    _need_card()
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_RING_WORKER)
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.launch",
                          "-n", "2", "--timeout", "150", "--",
                          sys.executable, str(script), str(tmp_path)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    rs = np.random.RandomState(0)
    whole = [torch.from_numpy(rs.randn(2, 4, 256, 64).astype(np.float32))
             for _ in range(3)]
    for r in range(2):
        got = json.loads((tmp_path / ("r%d.json" % r)).read_text())
        for causal in (1, 0):
            assert got["launches_%d_1" % causal] == 2
            assert got["launches_%d_0" % causal] == 0
            assert got["err_%d" % causal] <= 1e-5, got
    for causal in (True, False):
        joined = np.concatenate([np.load(tmp_path / ("ring_%d_r%d.npy"
                                                     % (causal, r)))
                                 for r in range(2)], axis=2)
        want = mt.parallel.attention(*whole, causal=causal).numpy()
        np.testing.assert_allclose(joined, want, rtol=1e-5, atol=1e-5)


# -- the engines and Module on meshes (slice 13) ------------------------------

def _mesh_tail_resnet(monkeypatch, tmp_path):
    """A narrow NHWC ResNet v1 with fused block tails (K1) on gpu(0): its
    symbol and parameters."""
    monkeypatch.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
    mt.layout.set_default_layout("NHWC")
    try:
        with mt.name.NameManager():
            net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                                  [16, 32, 64, 128, 256], classes=10)
        net.initialize(mt.init.Xavier(), ctx=mt.gpu(0))
        net(mt.nd.zeros((1, 32, 32, 3), ctx=mt.gpu(0)))
        with mt.name.NameManager():
            net.export(str(tmp_path / "net"))
    finally:
        mt.layout.set_default_layout(None)
    return (mt.sym.load(str(tmp_path / "net-symbol.json")),
            mt.nd.load(str(tmp_path / "net-0000.params"), ctx=mt.gpu(0)))


def test_one_member_serving_mesh_on_card_bit_equal(monkeypatch, tmp_path):
    """``{"dp": 1, "mp": 1}`` on ``[gpu(0)]`` runs the mesh path (shards,
    per-op gathers, the mesh forward) and serves the plain engine's bits,
    through K1."""
    _need_card()
    from mxnet_tpu_torch.parallel import PartitionRules, P
    from mxnet_tpu_torch.serving import InferenceEngine
    sym, params = _mesh_tail_resnet(monkeypatch, tmp_path)
    rules = PartitionRules([(r"weight$", P("mp")),
                            (r"(gamma|beta|bias)$", P("mp"))])
    x = np.random.RandomState(0).uniform(-1, 1, (3, 32, 32, 3)) \
        .astype(np.float32)
    with InferenceEngine(sym, params, {"data": (1, 32, 32, 3)}, max_batch=4,
                         ctx=mt.gpu(0)) as eng:
        want = eng.predict(data=x)[0]
    before = K.launches
    with InferenceEngine(sym, params, {"data": (1, 32, 32, 3)}, max_batch=4,
                         partition_rules=rules, mesh_axes={"dp": 1, "mp": 1},
                         contexts=[mt.gpu(0)]) as eng:
        got = eng.predict(data=x)[0]
        assert eng.partition_summary()["mesh_axes"] == {"dp": 1, "mp": 1}
    assert K.launches > before
    assert np.array_equal(got, want)


def test_one_member_decode_mesh_on_card_bit_equal():
    _need_card()
    from mxnet_tpu_torch.decode import AttentionDecodeCell, DecodeEngine
    from mxnet_tpu_torch.parallel.ring_attention import \
        DECODE_PARTITION_RULES
    cell = AttentionDecodeCell(64, 32, 8, 8, 48)
    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([9], np.int32)]
    got = {}
    for tag, kw in (("plain", {"ctx": mt.gpu(0)}),
                    ("mesh", {"partition_rules": DECODE_PARTITION_RULES,
                              "mesh_axes": {"dp": 1, "mp": 1},
                              "contexts": [mt.gpu(0)]})):
        with DecodeEngine(cell, cell.init_params(1), slots=2,
                          max_new_tokens=6, keep_logits=True, **kw) as eng:
            got[tag] = [eng.generate(p) for p in prompts]
    for a, b in zip(got["plain"], got["mesh"]):
        assert a.tokens == b.tokens and np.array_equal(a.logits, b.logits)


def test_one_member_module_mesh_on_card_equals_plain():
    """A mesh of one device is the plain path (the JAX package ignores
    the rules there): bit for bit the module without a mesh."""
    _need_card()
    from mxnet_tpu_torch.parallel import P
    data = mt.sym.Variable("data")
    sym = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        data, num_hidden=4, name="fc1"), name="softmax")
    rs = np.random.RandomState(0)
    w = {"fc1_weight": rs.randn(4, 8).astype(np.float32),
         "fc1_bias": np.zeros(4, np.float32)}
    x, y = rs.randn(16, 8).astype(np.float32), rs.randint(0, 4, 16)
    got = []
    for kw in ({}, {"partition_rules": [(r"weight$", P("mp", None))],
                    "mesh_axes": {"dp": 1, "mp": -1}}):
        mod = mt.mod.Module(sym, context=[mt.gpu(0)], **kw)
        mod.bind(data_shapes=[("data", (16, 8))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.gpu(0))
                                    for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        b = mt.io.DataBatch([mt.nd.array(x, ctx=mt.gpu(0))],
                            [mt.nd.array(y.astype(np.float32),
                                         ctx=mt.gpu(0))])
        assert mod._fused_batch_step(b)
        assert mod.partition_summary() is None
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in w:
        assert np.array_equal(got[0][k], got[1][k]), k


_MESH_WORKER = r'''
import json, os, sys
import numpy as np
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import P
from mxnet_tpu_torch.serving import InferenceEngine

out = sys.argv[1]
rank = mt.dist.rank()
sym = mt.sym.FullyConnected(mt.sym.Activation(mt.sym.FullyConnected(
    mt.sym.Variable("data"), num_hidden=64, name="fc1"), act_type="relu"),
    num_hidden=8, name="fc2")
rs = np.random.RandomState(3)
params = {"arg:fc1_weight": rs.randn(64, 16), "arg:fc1_bias": rs.randn(64),
          "arg:fc2_weight": rs.randn(8, 64), "arg:fc2_bias": rs.randn(8)}
params = {k: mt.nd.array(v.astype(np.float32), ctx=mt.gpu(0))
          for k, v in params.items()}
eng = InferenceEngine(sym, params, {"data": (1, 16)}, max_batch=4,
                      partition_rules=[(r"weight$", P("mp", None)),
                                       (r"bias$", P("mp"))],
                      mesh_axes={"dp": 1, "mp": 2}, contexts=[mt.gpu(0)])
res = {"rank": rank, "on": str(eng._param_raw["fc1_weight"].device)}
x = np.random.RandomState(4).randn(3, 16).astype(np.float32)
if rank == 0:
    res["out"] = eng.predict(data=x)[0].tolist()
else:
    try:
        eng.submit(data=x)
        res["refused"] = False
    except mt.MXNetError as e:
        res["refused"] = "rank 0" in str(e)
eng.close()
if rank == 0:
    with InferenceEngine(sym, params, {"data": (1, 16)}, max_batch=4,
                         ctx=mt.gpu(0)) as plain:
        res["plain"] = plain.predict(data=x)[0].tolist()
with open(os.path.join(out, "r%d.json" % rank), "w") as f:
    json.dump(res, f)
mt.dist.finalize()
'''


def test_serving_mesh_across_two_workers_on_card(tmp_path):
    """Two workers on ``cuda:0``, the FC net's weights split over ``mp``:
    rank 0 serves the one-device engine's bits, rank 1 follows and its
    ``submit`` raises naming rank 0."""
    _need_card()
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_MESH_WORKER)
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.launch",
                          "-n", "2", "--timeout", "150", "--",
                          sys.executable, str(script), str(tmp_path)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    r0, r1 = (json.loads((tmp_path / ("r%d.json" % r)).read_text())
              for r in range(2))
    assert r0["on"].startswith("cuda") and r1["on"].startswith("cuda")
    assert r1["refused"] is True
    assert r0["out"] == r0["plain"]


def test_group2ctx_copy_between_host_and_card():
    """A grouped executor with one group on ``cpu(0)`` and one on
    ``gpu(0)``: the activation crosses to the card and its gradient back
    to the host, each parameter and gradient on its group's device, and
    the forward and gradients equal an ungrouped run on the card within
    1e-6 of the largest value."""
    _need_card()
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (4, 6)).astype(np.float32)
    w1 = rs.uniform(-0.5, 0.5, (5, 6)).astype(np.float32)
    w2 = rs.uniform(-0.5, 0.5, (3, 5)).astype(np.float32)

    def run(g2c):
        with mt.AttrScope(ctx_group="g1"):
            net = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                        num_hidden=5, no_bias=True,
                                        name="fc1")
            net = mt.sym.Activation(net, act_type="tanh")
        with mt.AttrScope(ctx_group="g2"):
            net = mt.sym.FullyConnected(net, num_hidden=3, no_bias=True,
                                        name="fc2")
        ex = net.simple_bind(ctx=mt.gpu(0), grad_req="write",
                             group2ctx=g2c, data=(4, 6))
        ex.arg_dict["data"][:] = x
        ex.arg_dict["fc1_weight"][:] = w1
        ex.arg_dict["fc2_weight"][:] = w2
        out = ex.forward_backward(out_grads=mt.nd.ones((4, 3),
                                                       ctx=mt.gpu(0)),
                                  is_train=True)[0]
        return ex, out
    torch.backends.cuda.matmul.allow_tf32 = False
    ex, out = run({"g1": mt.cpu(0), "g2": mt.gpu(0)})
    assert ex.arg_dict["fc1_weight"]._data.device.type == "cpu"
    assert ex.grad_dict["fc1_weight"]._data.device.type == "cpu"
    assert ex.arg_dict["fc2_weight"]._data.is_cuda
    assert out._data.is_cuda and out.context == mt.gpu(0)
    ref_ex, ref = run(None)
    top = float(np.abs(ref.asnumpy()).max())
    assert np.abs(out.asnumpy() - ref.asnumpy()).max() <= 1e-6 * top
    for k in ("fc1_weight", "fc2_weight"):
        g, r = ex.grad_dict[k].asnumpy(), ref_ex.grad_dict[k].asnumpy()
        assert np.abs(g - r).max() <= 1e-6 * float(np.abs(r).max()), k


def test_gate_and_heartbeat_around_a_card_step(tmp_path):
    """A step on the card between two crossings of a gate whose peer is
    a thread of this process: both cross every generation, the wait the
    step reports (``note_wait``) is taken out of the published
    self-time, and the peer's stale heartbeat raises ``DeadWorkerError``
    while the card's work is still queued."""
    _need_card()
    import os
    import threading
    from mxnet_tpu_torch import heartbeat
    root = str(tmp_path)
    for r in (0, 1):
        with open(tmp_path / ("worker-%d" % r), "w") as f:
            f.write("0")
    g0 = heartbeat.CollectiveGate(0, (0, 1), root=root, poll=0.005)
    g1 = heartbeat.CollectiveGate(1, (0, 1), root=root, poll=0.005)
    a = torch.randn(2048, 2048, device="cuda")

    def peer():
        for _ in range(3):
            g1.arrive_and_wait()
    t = threading.Thread(target=peer)
    t.start()
    gens = []
    for _ in range(3):
        gens.append(g0.arrive_and_wait())
        b = a @ a
        torch.cuda.synchronize()
        g0.note_wait(1e6)           # all of it reported as waiting
    t.join(30)
    assert gens == [1, 2, 3]
    with open(g0._member_path(0)) as f:
        assert f.read().split()[2] == "0.000"   # self-time net of the wait
    os.utime(tmp_path / "worker-1", (1, 1))
    for _ in range(20):
        b = b @ a                    # queued on the card
    with pytest.raises(heartbeat.DeadWorkerError) as e:
        heartbeat.CollectiveGate(0, (0, 1), root=root, timeout=5,
                                 poll=0.005, channel="x").arrive_and_wait()
    assert e.value.ranks == (1,)
    torch.cuda.synchronize()


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_on_card_matches_cpu(transpose_a):
    """The sparse ``dot`` (gather and scatter-add on the compressed form)
    on the card against the same on the CPU, and its gradient for the
    dense rhs under ``record``."""
    _need_card()
    rs = np.random.RandomState(0)
    d = rs.randn(300, 500).astype(np.float32)
    d[rs.rand(300, 500) < 0.97] = 0
    w0 = rs.randn(300 if transpose_a else 500, 2).astype(np.float32)
    out = {}
    for ctx in (mt.cpu(), mt.gpu(0)):
        x = mt.nd.sparse.csr_matrix(d, ctx=ctx)
        w = mt.nd.array(w0, ctx=ctx)
        w.attach_grad()
        with mt.autograd.record():
            y = mt.nd.sparse.dot(x, w, transpose_a=transpose_a)
            loss = (y * y).sum()
        loss.backward()
        assert x._dense_cache is None
        out[ctx.device_type] = (y.asnumpy(), w.grad.asnumpy())
    for got, want in zip(out["gpu"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lazy_sgd_on_card_matches_cpu():
    """One lazy SGD step with momentum on the card: equal to the CPU's
    within 1e-6, the untouched rows of weight and momentum
    bit-unchanged."""
    _need_card()
    rs = np.random.RandomState(1)
    w0 = rs.randn(1000, 2).astype(np.float32)
    rows = np.sort(rs.choice(1000, 64, replace=False))
    g = rs.randn(64, 2).astype(np.float32)
    out = {}
    for ctx in (mt.cpu(), mt.gpu(0)):
        opt = mt.optimizer.create("sgd", learning_rate=0.5, momentum=0.9,
                                  wd=1e-4, rescale_grad=1 / 64)
        w = mt.nd.array(w0, ctx=ctx)
        st = opt.create_state(0, w)
        opt.update(0, w, mt.nd.sparse.row_sparse_array(
            (g, rows), shape=(1000, 2), ctx=ctx), st)
        out[ctx.device_type] = (w.asnumpy(), st.asnumpy())
    untouched = np.setdiff1d(np.arange(1000), rows)
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(out["gpu"][0][untouched], w0[untouched])
    np.testing.assert_array_equal(out["gpu"][1][untouched], 0.0)
