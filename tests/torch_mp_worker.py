"""Worker of ``tests/test_torch_model_parallel.py``: one rank of
``python -m mxnet_tpu_torch.launch -n 4 --force-cpu``.

Every rank runs every leg in the same order on its own shard of inputs
made from fixed numpy seeds (the test process makes the same global
arrays for the JAX package) and writes ``<leg>-r<rank>.npz`` under the
output directory:

- ``collectives``: ``ppermute`` (a ring and a partial permutation) and
  ``all_to_all`` over a 4-member ``sp`` axis, outputs and gradients;
  ``all_gather``, ``all_reduce``, ``broadcast``, ``reduce_scatter``;
- ``ring_*``: ring attention over ``{"sp": 4}`` and ``{"dp": 2, "sp":
  2}``, causal and not, the plain ring and the kernel route (its plain
  versions on the CPU): the member's output block and q/k/v gradients;
- ``ulysses_*``: Ulysses over ``{"dp": 2, "sp": 2}``;
- ``lm_ring``/``lm_ulysses``: the graft LM through ``SPMDTrainer``,
  3 steps, over ``{"dp": 1, "sp": 2, "tp": 2}`` (ring) and ``{"dp": 2,
  "sp": 2}`` (Ulysses): losses, whole parameters, the member's shards;
- ``moe_*``: ``moe_ffn`` over ``{"ep": 4}`` at a capacity that drops
  nothing and one that drops tokens: output block, gradients;
- ``pipeline``: ``pipeline_apply`` over ``{"pp": 4}``: output and the
  member's stage gradients.
"""
import os
import sys

import numpy as np
import torch

import mxnet_tpu_torch as mt

P = mt.parallel.P
CPU = mt.cpu()

# -- inputs shared with the test process ---------------------------------------

COLL_N = 4


def coll_inputs():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(COLL_N * 2, 6).astype(np.float32),
            "w": rs.randn(COLL_N * 2, 6).astype(np.float32),
            "a": rs.randn(COLL_N * 2, COLL_N * 3).astype(np.float32),
            "wa": rs.randn(COLL_N * 2 * COLL_N, 3).astype(np.float32)}


PARTIAL = [(0, 2), (2, 0), (1, 3)]
RING = [(i, (i + 1) % COLL_N) for i in range(COLL_N)]

ATTN_SHAPE = (2, 4, 16, 8)
RING_CASES = [("sp4", {"sp": 4}, True, False), ("sp4", {"sp": 4}, False,
                                                 True),
              ("dp2sp2", {"dp": 2, "sp": 2}, True, True),
              ("dp2sp2", {"dp": 2, "sp": 2}, False, False)]
ULYSSES_CASES = [(True, True), (False, False)]


def attn_inputs():
    rs = np.random.RandomState(1)
    return [rs.randn(*ATTN_SHAPE).astype(np.float32) for _ in range(4)]


def case_name(kind, mesh_tag, causal, use_pallas):
    return "%s_%s_c%d_k%d" % (kind, mesh_tag, causal, use_pallas)


V, E, H, S = 64, 32, 4, 16
GB = 4


def lm_params():
    """The graft LM's parameters (``__graft_entry__.py:76-86``)."""
    rng = np.random.RandomState(0)
    shapes = (("embed", (V, E)), ("wq", (E, E)), ("wk", (E, E)),
              ("wv", (E, E)), ("wo", (E, E)), ("w1", (4 * E, E)),
              ("w2", (E, 4 * E)), ("head", (V, E)))
    return {n: rng.normal(0, 0.02, s).astype(np.float32) for n, s in shapes}


def lm_batches(n=3):
    return [(np.random.RandomState(10 + i).randint(0, V, (GB, S))
             .astype(np.int32),
             np.random.RandomState(20 + i).randint(0, V, (GB, S))
             .astype(np.int32)) for i in range(n)]


LM_CASES = [("lm_ring", {"dp": 1, "sp": 2, "tp": 2}, "ring_attention"),
            ("lm_ulysses", {"dp": 2, "sp": 2}, "ulysses_attention")]

MOE_N, MOE_B, MOE_T, MOE_E, MOE_F = 4, 4, 8, 8, 16
MOE_CASES = [("moe_all", float(MOE_N * MOE_T)), ("moe_drop", 1.0)]


def moe_inputs():
    rs = np.random.RandomState(3)
    return {"x": rs.randn(MOE_B, MOE_T, MOE_E).astype(np.float32) * 0.5,
            "wr": rs.randn(MOE_N, MOE_E).astype(np.float32),
            "w1": rs.randn(MOE_N, MOE_F, MOE_E).astype(np.float32) * 0.1,
            "w2": rs.randn(MOE_N, MOE_E, MOE_F).astype(np.float32) * 0.1,
            "g": rs.randn(MOE_B, MOE_T, MOE_E).astype(np.float32)}


PP_N, PP_MICRO, PP_E = 4, 6, 8


def pipe_inputs():
    rs = np.random.RandomState(4)
    return {"x": rs.randn(PP_MICRO, 2, PP_E).astype(np.float32),
            "w": rs.randn(PP_N, PP_E, PP_E).astype(np.float32) * 0.3,
            "b": rs.randn(PP_N, PP_E).astype(np.float32) * 0.1,
            "g": rs.randn(PP_MICRO, 2, PP_E).astype(np.float32)}


def lm_apply(attn, batch, seq):
    """``__graft_entry__.py:88-104`` on this member's ``batch`` rows of
    ``seq`` positions."""
    d = E // H

    def apply_fn(p, x, y):
        e = p["embed"][x.long()]

        def split(t):
            return t.reshape(batch, seq, H, d).permute(0, 2, 1, 3)
        a = attn(split(e @ p["wq"].T), split(e @ p["wk"].T),
                 split(e @ p["wv"].T))
        h = e + a.permute(0, 2, 1, 3).reshape(batch, seq, E) @ p["wo"].T
        h = h + torch.relu(h @ p["w1"].T) @ p["w2"].T
        logp = torch.log_softmax(h @ p["head"].T, dim=-1)
        return (-logp.gather(-1, y.long()[..., None])).mean()
    return apply_fn


def block(a, mesh, spec):
    """This member's block of a whole numpy array."""
    return mt.parallel.shard_put(a, mt.parallel.Placement(mesh, spec))


# -- legs -------------------------------------------------------------------------

def collectives_leg():
    C = mt.parallel.collectives
    mesh = mt.parallel.make_mesh({"sp": COLL_N}, devices=[CPU])
    g = mesh.group("sp")
    inp = coll_inputs()
    x = block(inp["x"], mesh, P("sp")).requires_grad_()
    w = block(inp["w"], mesh, P("sp"))
    out = {}
    for tag, perm in (("ring", RING), ("partial", PARTIAL)):
        y = C.ppermute(x, g, perm)
        (dx,) = torch.autograd.grad((y * w).sum(), [x])
        out["ppermute_%s" % tag], out["ppermute_%s_dx" % tag] = y, dx
    a = block(inp["a"], mesh, P("sp")).requires_grad_()
    wa = block(inp["wa"], mesh, P("sp"))
    y = C.all_to_all(a, g, split_axis=1, concat_axis=0)
    (da,) = torch.autograd.grad((y * wa).sum(), [a])
    out["all_to_all"], out["all_to_all_da"] = y, da
    out["all_gather"] = C.all_gather(x.detach(), g)
    out["all_gather_stacked"] = C.all_gather(x.detach(), g, tiled=False)
    out["all_reduce"] = C.all_reduce(x.detach(), g)
    out["all_reduce_max"] = C.all_reduce(x.detach(), g, op="max")
    out["broadcast"] = C.broadcast(x.detach(), src=2, group=g)
    out["reduce_scatter"] = C.reduce_scatter(a.detach(), g, 1)
    out["axis_index"] = torch.tensor(mesh.axis_index("sp"))
    return out


def attention_leg(kind, axes, causal, use_pallas):
    mesh = mt.parallel.make_mesh(axes, devices=[CPU])
    batch_axis = "dp" if "dp" in axes else None
    spec = P(batch_axis, None, "sp", None)
    q, k, v, w = (block(a, mesh, spec) for a in attn_inputs())
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fn = getattr(mt.parallel, kind)
    o = fn(q, k, v, mesh, axis_name="sp", batch_axis_name=batch_axis,
           causal=causal, use_pallas=use_pallas)
    dq, dk, dv = torch.autograd.grad((o * w).sum(), [q, k, v])
    return {"out": o, "dq": dq, "dk": dk, "dv": dv}


def lm_leg(axes, attn_name):
    mesh = mt.parallel.make_mesh(axes, devices=[CPU])
    fn = getattr(mt.parallel, attn_name)

    def attn(q, k, v):
        return fn(q, k, v, mesh, axis_name="sp", batch_axis_name="dp",
                  causal=True)
    batch, seq = GB // mesh.shape["dp"], S // mesh.shape["sp"]
    tp = "tp" if "tp" in axes else None
    tr = mt.parallel.SPMDTrainer(lm_apply(attn, batch, seq), lm_params(),
                                 mesh, data_axis="dp", tp_axis=tp,
                                 learning_rate=0.1, momentum=0.9,
                                 batch_specs=[P("dp", "sp")] * 2)
    losses = [float(tr.step(x, y)) for x, y in lm_batches()]
    out = {"losses": torch.tensor(losses, dtype=torch.float64)}
    out.update({"param/" + k: torch.from_numpy(v)
                for k, v in tr.get_params().items()})
    out.update({"shard/" + k: v for k, v in tr.params.items()})
    return out


def moe_leg(capacity_factor):
    C = mt.parallel.collectives
    mesh = mt.parallel.make_mesh({"ep": MOE_N}, devices=[CPU])
    inp = moe_inputs()
    x = block(inp["x"], mesh, P("ep")).requires_grad_()
    wr = torch.from_numpy(inp["wr"]).requires_grad_()
    w1 = block(inp["w1"], mesh, P("ep")).requires_grad_()
    w2 = block(inp["w2"], mesh, P("ep")).requires_grad_()
    g = block(inp["g"], mesh, P("ep"))
    y = mt.parallel.moe_ffn(x, wr, w1, w2, mesh,
                            capacity_factor=capacity_factor)
    dx, dwr, dw1, dw2 = torch.autograd.grad((y * g).sum(), [x, wr, w1, w2])
    return {"out": y, "dx": dx, "dwr": C.all_reduce(dwr, mesh.group("ep")),
            "dw1": dw1, "dw2": dw2}


def pipeline_leg():
    mesh = mt.parallel.make_mesh({"pp": PP_N}, devices=[CPU])
    inp = pipe_inputs()
    w = block(inp["w"], mesh, P("pp")).requires_grad_()
    b = block(inp["b"], mesh, P("pp")).requires_grad_()

    def stage(p, mb):
        return torch.tanh(mb @ p["w"] + p["b"])
    y = mt.parallel.pipeline_apply(stage, {"w": w, "b": b},
                                   torch.from_numpy(inp["x"]), mesh)
    dw, db = torch.autograd.grad((y * torch.from_numpy(inp["g"])).sum(),
                                 [w, b])
    return {"out": y, "dw": dw, "db": db}


def main(out):
    torch.set_num_threads(1)
    rank = mt.dist.rank()
    assert mt.dist.process_count() == 4, mt.dist.process_count()

    def save(name, arrays):
        np.savez(os.path.join(out, "%s-r%d.npz" % (name, rank)),
                 **{k: v.detach().numpy() for k, v in arrays.items()})
    save("collectives", collectives_leg())
    for tag, axes, causal, use_pallas in RING_CASES:
        save(case_name("ring", tag, causal, use_pallas),
             attention_leg("ring_attention", axes, causal, use_pallas))
    for causal, use_pallas in ULYSSES_CASES:
        save(case_name("ulysses", "dp2sp2", causal, use_pallas),
             attention_leg("ulysses_attention", {"dp": 2, "sp": 2}, causal,
                           use_pallas))
    for name, axes, attn in LM_CASES:
        save(name, lm_leg(axes, attn))
    for name, cf in MOE_CASES:
        save(name, moe_leg(cf))
    save("pipeline", pipeline_leg())
    mt.dist.finalize()


if __name__ == "__main__":
    main(sys.argv[1])
