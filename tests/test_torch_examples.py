"""The port's example twins against the JAX package's examples, on the CPU.

Each twin runs with ``--device cpu`` beside the reference example's own code
on the same draws:

- ``quickstart``: the reference script run for 3 rounds (its ``ROUNDS``
  constant set to 3) prints the twin's lines — FA, policy, rounds, DP
  metrics, epsilon and the funnel report — the loss and metric digits
  included;
- ``async_vs_sync``: the fleet-simulation lines equal (numpy), the
  buffered-async run's loss line equal at 48 pushes, the simulated clocks
  of the sync and async event loops equal and their final losses within
  1e-4 (the round's 1e-5 tolerance through a 4-digit print); the
  reference script's convergence assert is taken out of its copy (its own
  loss rises at the full 400 pushes, see the twin's docstring);
- ``serve_on_device``: ``serve.main`` with the example's argv prints the
  reference's int8 and sample lines;
- ``fl_llm_finetune``: 3 rounds at cohort 4, plain and ``--masked
  --chunk-elems 65536`` (9 chunks, one mask session each): the arch and
  plan lines equal, each round's loss and clip fraction and the final loss
  line within a unit of the printed digit (the round's ~1e-5); both
  examples' "the loss fell" asserts are taken out at 3 rounds, and the
  twin's is held apart (it fails a run whose loss does not fall); the
  twin's checkpoint restores in the reference;
- ``observability_smoke`` is held in ``tests/test_torch_obs.py``.
"""
import io
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from repro_torch.examples import (async_vs_sync, fl_llm_finetune, quickstart,
                                   serve_on_device)
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

REPO = Path(__file__).resolve().parents[1]


def _run_reference(name: str, edits) -> list:
    """Run ``examples/<name>.py``'s source with ``edits`` (old, new) applied;
    returns its printed lines."""
    src = (REPO / "examples" / f"{name}.py").read_text()
    for old, new in edits:
        assert old in src, old
        src = src.replace(old, new)
    buf = io.StringIO()
    with redirect_stdout(buf):
        exec(compile(src, f"examples/{name}.py", "exec"),
             {"__name__": "__main__"})
    return buf.getvalue().splitlines()


def _run_port(main, argv) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_quickstart_twin_prints_the_reference_lines():
    got = _run_port(quickstart.main, ["--device", "cpu", "--rounds", "3"])
    want = _run_reference("quickstart", [
        ("COHORT, ROUNDS, POPULATION = 64, 40, 4096",
         "COHORT, ROUNDS, POPULATION = 64, 3, 4096")])
    assert got == want


def _numbers(line: str):
    return [float(x) for x in re.findall(r"-?\d+\.\d+|-?\d+", line)]


def test_async_vs_sync_twin_prints_the_reference_lines():
    got = _run_port(async_vs_sync.main, ["--device", "cpu", "--pushes", "48",
                                         "--target-updates", "32"])
    want = _run_reference("async_vs_sync", [
        ("for t in range(400):", "for t in range(48):"),
        ("assert np.mean(losses[-20:]) < np.mean(losses[:20])\n", ""),
        ("target_updates=128", "target_updates=32")])
    assert len(got) == len(want) == 13
    assert got[:5] == want[:5]  # the numpy fleet simulation
    assert got[6] == want[6]  # "async loss a -> b over 48 pushes, ..."
    assert got[7] == want[7]
    for g, w in zip(got[10:12], want[10:12]):  # sync / async event loops
        gn, wn = _numbers(g), _numbers(w)
        assert gn[0] == wn[0]  # simulated wall clock
        assert gn[-1] == pytest.approx(wn[-1], abs=1e-4)  # final loss
    assert got[12] == want[12]  # simulated speedup


def test_serve_on_device_twin_prints_the_reference_lines():
    from repro.launch import serve as jserve
    got = _run_port(serve_on_device.main, ["--device", "cpu"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert jserve.main(serve_on_device.ARGV) == 0
    want = buf.getvalue().splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0]  # the int8 MiB line
    assert got[3] == want[3]  # the sampled tokens
    assert got[1].startswith("prefill: 4x32 in ")
    assert got[2].startswith("decode: 16 steps in ")


@pytest.mark.parametrize("extra", [[], ["--masked", "--chunk-elems",
                                        "65536"]])
def test_fl_llm_finetune_twin_prints_the_reference_lines(extra, tmp_path,
                                                         monkeypatch):
    import jax
    import numpy as np

    from repro.checkpoint import checkpoint as jck
    from repro_torch import tree as T
    argv = ["--rounds", "3", "--cohort", "4"] + extra
    session = {}
    # at 3 rounds the loss need not fall: both examples' asserts are taken out
    monkeypatch.setattr(fl_llm_finetune, "check_loss_fell", lambda _: None)
    got = _run_port(lambda a: fl_llm_finetune.main(a, session=session),
                    argv + ["--device", "cpu", "--checkpoint-dir",
                            str(tmp_path)])
    monkeypatch.setattr(sys, "argv", ["fl_llm_finetune.py"] + argv)
    want = _run_reference("fl_llm_finetune", [(
        'assert np.mean(losses[-10:]) < losses[0], '
        '"training must improve the loss"\n', "")])
    assert got[:2] == want[:2]  # arch=... params=..., plan: ...
    if extra:
        assert "9 chunk(s)" in got[1] and "masked=True" in got[1]
    rows = [(_numbers(g), _numbers(w)) for g, w in zip(got[2:4], want[2:4])]
    for g, w in rows:  # round r  loss=  clip%=  tok/s=  eps=inf
        assert g[0] == w[0]
        assert g[1] == pytest.approx(w[1], abs=1.01e-4)
        assert g[2] == pytest.approx(w[2], abs=1.01e-2)
    g, w = _numbers(got[5]), _numbers(want[5])  # "loss a -> b (3 rounds"
    assert g[:3] == pytest.approx(w[:3], abs=1.01e-3)
    assert (got[6:], want[6:]) == (["checkpointed."], [])
    tree, man = jck.restore(str(tmp_path / "step_3"))
    assert man["step"] == 3
    for a, b in zip(jax.tree.leaves(tree["params"]),
                    T.leaves(session["state"].params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_fl_llm_finetune_twin_fails_when_the_loss_does_not_fall():
    """F7: the twin keeps the reference's assert.  One round cannot improve
    on the first loss, so the process exits 1 naming the assert."""
    import os
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.fl_llm_finetune",
         "--device", "cpu", "--rounds", "1", "--cohort", "2", "--seq-len",
         "8", "--layers", "1", "--d-model", "32", "--vocab", "64"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "training must improve the loss" in out.stderr
    assert "loss " in out.stdout


@pytest.mark.parametrize("losses,fell", [([2.0, 1.5, 1.0], True),
                                         ([1.0, 1.5, 2.0], False),
                                         ([1.0], False)])
def test_fl_llm_finetune_check_is_the_reference_assert(losses, fell):
    if fell:
        fl_llm_finetune.check_loss_fell(losses)
    else:
        with pytest.raises(AssertionError, match="must improve the loss"):
            fl_llm_finetune.check_loss_fell(losses)
