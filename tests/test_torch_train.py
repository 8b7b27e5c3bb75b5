"""The port's training CLI (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``), both on the CPU.

The classifier run prints the reference's lines: every round's loss,
clip fraction, update norm and epsilon agree to the printed precision within
one unit of the last digit (the weights, the keys, the uniforms and the TEE
noise are the reference's draws, bit for bit; gradients and f32 sums differ
in the last bits, and XLA adds the noise as one FMA).  The reduced qwen2 run trains
and prints finite numbers; unported options raise.
"""
import re

import numpy as np
import pytest

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

LINE = re.compile(r"round\s+(\d+) loss=(\S+) clip%=(\S+) \|u\|=(\S+) "
                  r"eps\(1e-6\)=(\S+) ")


def _rounds(text):
    return [tuple(float(v) for v in m.groups()) for m in LINE.finditer(text)]


def test_classifier_run_prints_the_reference_lines(capsys):
    argv = ["--classifier", "--rounds", "8", "--cohort", "16",
            "--log-every", "1"]
    assert jtrain.main(argv) == 0
    want = capsys.readouterr().out
    session = {}
    assert ttrain.main(argv + ["--device", "cpu"], session=session) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]  # model params: 4,225
    w, g = _rounds(want), _rounds(got)
    assert len(w) == len(g) == 8
    for a, b in zip(w, g):
        assert a[0] == b[0]
        # one unit of each printed column: loss, clip%, |u|, eps
        for x, y, unit in zip(a[1:], b[1:], (1e-4, 1e-2, 1e-3, 1e-2)):
            assert abs(x - y) <= 1.01 * unit, (a, b)
    assert len(session["metrics"]) == 8
    assert int(session["state"].round_idx) == 8


def test_reduced_qwen2_run_on_cpu(capsys):
    session = {}
    assert ttrain.main(["--rounds", "2", "--cohort", "4", "--seq-len", "16",
                        "--log-every", "1", "--device", "cpu"],
                       session=session) == 0
    rows = _rounds(capsys.readouterr().out)
    assert len(rows) == 2
    assert all(np.isfinite(r).all() for r in rows)
    assert all(np.isfinite(m["loss"]) for m in session["metrics"])


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="checkpoint"):
        ttrain.main(["--classifier", "--checkpoint-dir", "ckpt",
                     "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1, item 2,"):
        ttrain.main(["--arch", "mamba2-780m", "--rounds", "1",
                     "--device", "cpu"])
