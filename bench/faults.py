"""Faults planted in the system under test, for the checks that ``correct``
catches them (``tests/test_bench_faults.py`` on the CPU, ``calibrate.py``
on the card).  Nothing of a benchmark run imports this module.

  unchanged  the server step returns the parameters it was given;
  half       half of each batch left out, the mean taken over the rest
             (a zero weight on every other contribution or cohort member);
  altered    an answer altered where it is produced: the decoded mean's
             first leaf doubled.

The exchange between chips does not exist in a one-chip cell.
"""
from __future__ import annotations

import contextlib
import itertools
from unittest import mock

FAULTS = ("unchanged", "half", "altered")


def _frozen_opt(build):
    def build_frozen(fl_cfg):
        opt = build(fl_cfg)
        return opt._replace(apply=lambda params, state, delta: (params,
                                                                state))
    return build_frozen


def _double_first(fn):
    def wrapped(*args, **kw):
        from repro_torch import tree as T
        mean = fn(*args, **kw)
        paths, leaves = T.flatten(mean)
        return T.unflatten(paths, [leaves[0] * 2] + leaves[1:])
    return wrapped


def _half_weights(fn):
    calls = itertools.count()

    def wrapped(*args, **kw):
        w = fn(*args, **kw)
        return w * 0 if next(calls) % 2 else w
    return wrapped


def _half_batch(step):
    def wrapped(state, batch, rng):
        import torch
        c = next(iter(batch.values())).shape[0]
        w = torch.tensor([1.0 - (i % 2) for i in range(c)],
                         device=next(iter(batch.values())).device)
        return step(state, dict(batch, weight=w), rng)
    return wrapped


def plant(name: str, entry: str):
    """(a context manager that plants fault ``name`` while the cell is built
    and run, the keyword arguments its ``Cell`` takes for it)."""
    from repro_torch.core.fl import aggregation, async_fl, round as rnd
    stack = contextlib.ExitStack()
    kwargs = {}
    if name == "unchanged":
        for mod in (async_fl, rnd):
            stack.enter_context(mock.patch.object(
                mod, "build_server_opt", _frozen_opt(mod.build_server_opt)))
    elif name == "half":
        if entry == "agg":
            stack.enter_context(mock.patch.object(
                async_fl, "staleness_weight",
                _half_weights(async_fl.staleness_weight)))
        else:
            kwargs["step_wrapper"] = _half_batch
    elif name == "altered":
        target = ("finalize_plan_aggregate" if entry == "agg"
                  else "finalize_aggregate")
        stack.enter_context(mock.patch.object(
            aggregation, target, _double_first(getattr(aggregation, target))))
    else:
        raise ValueError(f"fault {name!r}; have {FAULTS}")
    return stack, kwargs
