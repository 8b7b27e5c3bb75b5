"""The port's training CLI (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``), both on the CPU.

The classifier run prints the reference's lines: every round's loss,
clip fraction, update norm and epsilon agree to the printed precision
within one unit of the last digit (the weights, the keys, the uniforms and
the TEE noise are the reference's draws, bit for bit; gradients and f32
sums differ in the last bits, and XLA adds the noise as one FMA); every
registry architecture's run is held the same way in
``tests/test_torch_train_archs.py``.  The reduced qwen2 run trains and
prints finite numbers; a ``--checkpoint-dir`` run writes the reference's
checkpoint of its final state.
"""
import re

import jax
import numpy as np
import pytest

from repro.checkpoint import checkpoint as jck
from repro.launch import train as jtrain
from repro_torch import tree as T
from repro_torch.launch import train as ttrain
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

LINE = re.compile(r"round\s+(\d+) loss=(\S+) clip%=(\S+) \|u\|=(\S+) "
                  r"eps\(1e-6\)=(\S+) ")


def _rounds(text):
    return [tuple(float(v) for v in m.groups()) for m in LINE.finditer(text)]


def _same_rounds(want, got, n):
    w, g = _rounds(want), _rounds(got)
    assert len(w) == len(g) == n
    for a, b in zip(w, g):
        assert a[0] == b[0]
        # one unit of each printed column: loss, clip%, |u|, eps
        for x, y, unit in zip(a[1:], b[1:], (1e-4, 1e-2, 1e-3, 1e-2)):
            assert abs(x - y) <= 1.01 * unit, (a, b)


def test_classifier_run_prints_the_reference_lines(capsys):
    argv = ["--classifier", "--rounds", "8", "--cohort", "16",
            "--log-every", "1"]
    assert jtrain.main(argv) == 0
    want = capsys.readouterr().out
    session = {}
    assert ttrain.main(argv + ["--device", "cpu"], session=session) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]  # model params: 4,225
    _same_rounds(want, got, 8)
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


def test_checkpoint_dir_run_restores_in_the_reference(tmp_path, capsys):
    """``--checkpoint-dir`` saves ``{"params", "opt"}`` at ``step_<r+1>``
    with the reference's metadata; the reference's restore of the last one
    equals the port's final state bit for bit, and the reference's own run
    writes a checkpoint with the same structure, step and metadata keys."""
    argv = ["--rounds", "2", "--cohort", "4", "--seq-len", "16",
            "--checkpoint-dir", str(tmp_path / "t"), "--checkpoint-every",
            "1"]
    session = {}
    assert ttrain.main(argv + ["--device", "cpu"], session=session) == 0
    assert "checkpointed -> " + str(tmp_path / "t" / "step_2") in \
        capsys.readouterr().out
    assert jck.latest_step_dir(str(tmp_path / "t")) == str(
        tmp_path / "t" / "step_2")
    tree, man = jck.restore(str(tmp_path / "t" / "step_2"))
    assert man["step"] == 2 and man["metadata"]["arch"] == "qwen2-1.5b"
    state = session["state"]
    want = dict(zip(*T.flatten(state.params)))
    got = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert len(got) == len(want)
    for path, x in got:
        np.testing.assert_array_equal(
            np.asarray(x), want[tuple(k.key for k in path)].numpy())
    opt = T.leaves(state.opt_state)
    assert len(opt) == len(jax.tree.leaves(tree["opt"])) > 0
    for a, b in zip(jax.tree.leaves(tree["opt"]), opt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jtrain.main(argv[:-4] + ["--checkpoint-dir", str(tmp_path / "j"),
                                    "--checkpoint-every", "1"]) == 0
    jtree, jman = jck.restore(str(tmp_path / "j" / "step_2"))
    assert jman["step"] == 2
    assert sorted(jman["metadata"]["fl"]) == sorted(
        k for k in man["metadata"]["fl"] if k != "device")
    assert (jax.tree_util.tree_structure(jtree)
            == jax.tree_util.tree_structure(tree))
