"""Learning-rate schedules of the port: ``LRScheduler``,
``FactorScheduler`` and ``MultiFactorScheduler``, copied from the
framework-free ``mxnet_tpu/lr_scheduler.py`` L19-97 (reference API:
python/mxnet/lr_scheduler.py). ``PolyScheduler`` and ``CosineScheduler``
are not yet copied (ROADMAP A2).

A scheduler is a callable `num_update -> lr`. Each schedule derives the
rate in closed form from the update count and folds it into the mutable
`base_lr` attribute, which stays part of the contract: the Optimizer
seeds it with `learning_rate`, callers may overwrite it mid-training,
and step-decay schedules then continue scaling from the new value.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    """Base class: subclasses implement `__call__(num_update) -> lr`.

    `num_update` is the optimizer's max per-weight update count — it only
    moves forward, and schedules may be called with the same value many
    times (one call per weight per step), so `__call__` must be
    idempotent for a fixed count.
    """

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """Multiply the rate by `factor` once every `step` updates, flooring
    at `stop_factor_lr`.

    The number of decay boundaries passed by update `n` is
    `(n - 1) // step`; the difference against the boundaries already
    folded in is applied to `base_lr` in one shot, so externally
    resetting `base_lr` mid-run rescales the remaining schedule exactly
    like the reference's incremental loop."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1, got %r" % (step,))
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._boundaries_applied = 0

    def __call__(self, num_update):
        crossed = max(0, (num_update - 1) // self.step)
        newly = crossed - self._boundaries_applied
        if newly > 0:
            self._boundaries_applied = crossed
            decayed = self.base_lr * self.factor ** newly
            if decayed <= self.stop_factor_lr:
                if self.base_lr > self.stop_factor_lr:
                    logging.info("Update[%d]: lr floored at %0.5e",
                                 num_update, self.stop_factor_lr)
                self.base_lr = self.stop_factor_lr
            else:
                self.base_lr = decayed
                logging.info("Update[%d]: lr decayed to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Multiply the rate by `factor` as each milestone in `step` (a
    strictly increasing list of update counts) is passed."""

    def __init__(self, step, factor=1, base_lr=0.01):
        super().__init__(base_lr)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("step must be strictly increasing, got %r"
                             % (step,))
        self.step = step
        self.factor = factor
        self._boundaries_applied = 0

    def __call__(self, num_update):
        crossed = sum(1 for s in self.step if num_update > s)
        newly = crossed - self._boundaries_applied
        if newly > 0:
            self._boundaries_applied = crossed
            self.base_lr *= self.factor ** newly
            logging.info("Update[%d]: lr decayed to %0.5e", num_update,
                         self.base_lr)
        return self.base_lr
