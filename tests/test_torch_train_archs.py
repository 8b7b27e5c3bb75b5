"""``repro_torch.launch.train --arch X`` against ``repro.launch.train
--arch X`` for every registry architecture at its reduced config, both on
the CPU: the parameter count and each round's printed loss, clip fraction,
update norm and epsilon within one unit of the last digit (the weights, the
batches with their stub patch and frame embeddings, the keys and the draws
are the reference's; gradients and f32 sums differ in the last bits).
"""
import re

import numpy as np
import pytest

from repro.configs.registry import ARCH_IDS
from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

LINE = re.compile(r"round\s+(\d+) loss=(\S+) clip%=(\S+) \|u\|=(\S+) "
                  r"eps\(1e-6\)=(\S+) ")


def _same_rounds(want, got, n):
    w = [tuple(float(v) for v in m.groups()) for m in LINE.finditer(want)]
    g = [tuple(float(v) for v in m.groups()) for m in LINE.finditer(got)]
    assert len(w) == len(g) == n
    for a, b in zip(w, g):
        assert a[0] == b[0]
        # one unit of each printed column: loss, clip%, |u|, eps
        for x, y, unit in zip(a[1:], b[1:], (1e-4, 1e-2, 1e-3, 1e-2)):
            assert abs(x - y) <= 1.01 * unit, (a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_prints_the_reference_round_lines(arch, capsys):
    """``--arch X`` at the reduced config, 2 rounds, cohort 4, sequence 16:
    the parameter count and both round lines are the reference's."""
    argv = ["--arch", arch, "--rounds", "2", "--cohort", "4", "--seq-len",
            "16", "--log-every", "1"]
    assert jtrain.main(argv) == 0
    want = capsys.readouterr().out
    session = {}
    assert ttrain.main(argv + ["--device", "cpu"], session=session) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    _same_rounds(want, got, 2)
    assert all(np.isfinite(m["loss"]) for m in session["metrics"])
