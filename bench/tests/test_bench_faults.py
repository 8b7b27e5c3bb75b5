"""``correct`` comes out false for every fault a cell can have, planted
under the timed path of a CPU rehearsal, and for the control."""
import pytest

from bench import faults
from bench import harness as H
from bench.tests.small import small_spec
from repro_torch.core.telemetry import Telemetry

CASES = [(c, f) for c in ("agg.whisper-tiny.tee", "agg.whisper-tiny.drop",
                          "agg.mamba2-780m.tee", "train.whisper-tiny")
         for f in faults.FAULTS]


def _run(cell, seed, fault=None, control=False):
    spec = small_spec(cell)
    entry = spec["traffic"]["entry"]
    stack, kw = faults.plant(fault, entry) if fault else (None, {})
    if stack is not None:
        stack.__enter__()
    try:
        run = H.load_entry(entry).Cell(spec, seed, "cpu",
                                       Telemetry(record_spans=False), **kw)
        run.window(1.5)
    finally:
        if stack is not None:
            stack.__exit__(None, None, None)
    return run.check(spec["cell"]["limits"], control=control)


def _correct(checks, prefix=""):
    return all(v <= lim for k, (v, lim) in checks.items()
               if k.startswith(prefix) and (prefix or "." not in k))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    checks = _run(cell, 31, fault)
    assert not _correct(checks), checks


@pytest.mark.parametrize("cell", ["agg.whisper-tiny.tee",
                                  "agg.whisper-tiny.drop"])
def test_agg_control_is_caught(cell):
    checks = _run(cell, 32, control=True)
    assert _correct(checks), checks
    assert not _correct(checks, "control."), checks


@pytest.mark.cuda
def test_train_control_is_caught_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs the card's tensor cores")
    spec = small_spec("train.whisper-tiny")
    run = H.load_entry("train").Cell(spec, 33, "cuda",
                                     Telemetry(record_spans=False))
    run.window(0.3)
    checks = run.check(spec["cell"]["limits"], control=True)
    assert _correct(checks) and not _correct(checks, "control."), checks
