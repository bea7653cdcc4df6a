"""Faults planted in the program underneath a run, to show that the
comparison catches them (the CPU tests, and ``controls.py`` on the card):

- ``state_unchanged``: a step that computes its loss and returns the
  tables' state as it found it;
- ``half_batch``: a step on the first half of its batch only, its loss and
  gradients the mean over that half.

Each patches the two calls the windows drive, ``PSTrainStep.__call__`` and
``DenseTable.step_inplace``, for the length of a ``with`` block.
"""

from __future__ import annotations

import contextlib

import torch

from minips_tpu_torch.tables.dense import DenseTable
from minips_tpu_torch.train.ps_step import PSTrainStep


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


def _half(batch: dict) -> dict:
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


@contextlib.contextmanager
def _patched(ps_call, dense_step):
    saved = PSTrainStep.__call__, DenseTable.step_inplace
    PSTrainStep.__call__, DenseTable.step_inplace = ps_call, dense_step
    try:
        yield
    finally:
        PSTrainStep.__call__, DenseTable.step_inplace = saved


def state_unchanged():
    def ps_call(self, batch):
        # the sparse rows update in place: step a copy, keep the original
        _, loss = self.step_fn_pure(_clone(self._collect_state()), batch)
        return loss

    def dense_step(self, step, batch):
        return step(self.params, self.opt_state, batch)[2]

    return _patched(ps_call, dense_step)


def half_batch():
    ps_orig, dense_orig = PSTrainStep.__call__, DenseTable.step_inplace

    def ps_call(self, batch):
        return ps_orig(self, _half(batch))

    def dense_step(self, step, batch):
        return dense_orig(self, step, _half(batch))

    return _patched(ps_call, dense_step)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
