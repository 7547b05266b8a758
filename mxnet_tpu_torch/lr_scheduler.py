"""Learning-rate schedulers (parity: python/mxnet/lr_scheduler.py).

Counterpart of ``mxnet_tpu/lr_scheduler.py``, kept as a copy: the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (parity: FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given step milestones (parity: MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0, base_lr=0.01):
        super().__init__(base_lr)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise ValueError("steps must be increasing")
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over max_update steps."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * pow(
                1.0 - float(num_update) / float(self.max_update), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay (TPU-era convenience addition)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, warmup_steps=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.base_lr_orig * num_update / max(1, self.warmup_steps)
        t = min(num_update - self.warmup_steps,
                self.max_update - self.warmup_steps)
        frac = t / max(1, self.max_update - self.warmup_steps)
        return self.final_lr + (self.base_lr_orig - self.final_lr) * \
            0.5 * (1 + math.cos(math.pi * frac))
