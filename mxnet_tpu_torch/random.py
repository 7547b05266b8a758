"""Global random-number state (parity: ``mx.random``).

Counterpart of ``mxnet_tpu/random.py``. The JAX package keeps one
splittable key; here there is one explicit ``torch.Generator`` per
device, all seeded by :func:`seed`. ``imperative.invoke``, the graph
executor (``hybridize`` and ``Module``) and ``gluon.block.make_pure_fn``
hand the generator of the op's device to every op that takes ``_rng``
(``ops/common.take_rng``), so one seed gives the same masks and samples
in the same order of random ops. PyTorch's CPU and CUDA generators are
different algorithms, so a seed draws differently on the two devices,
and neither draws what ``jax.random`` draws.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "get_state", "set_state", "generator"]

_lock = threading.Lock()
_seed = 0
_generators = {}    # torch.device -> torch.Generator


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state, ctx="all"):
    """Seed the generator of every device (``ctx="all"``) or of one
    Context (parity: ``mx.random.seed``)."""
    global _seed
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            for g in _generators.values():
                g.manual_seed(_seed)
            return
        dev = _key(ctx.torch_device())
        gen = _generators.get(dev)
        if gen is None:
            gen = _generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(int(seed_state))


def generator(device):
    """The generator of ``device`` (made, seeded with the last global
    seed, at its first use)."""
    dev = _key(device)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = _generators[dev] = torch.Generator(device=dev)
            gen.manual_seed(_seed)
        return gen


def get_state():
    """JSON-safe snapshot: the global seed and each device generator's
    state as a list of ints, what a checkpoint keeps so a resumed run
    draws what the interrupted run would have."""
    with _lock:
        return {"seed": _seed,
                "generators": {str(d): g.get_state().tolist()
                               for d, g in _generators.items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot."""
    global _seed
    with _lock:
        _seed = int(state["seed"])
        for name, st in state["generators"].items():
            dev = _key(name)
            gen = _generators.get(dev)
            if gen is None:
                gen = _generators[dev] = torch.Generator(device=dev)
            gen.set_state(torch.tensor(st, dtype=torch.uint8))
