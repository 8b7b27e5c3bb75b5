"""What the benchmark's processes load: neither JAX nor the JAX package the
system was ported from, and in the references nothing of the system; and
nothing written outside the checkout and the given directories."""
import re
import subprocess
import sys

from bench import harness as H

TOP = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][A-Za-z0-9_]*)", re.M)


def _tops(path):
    return set(TOP.findall(path.read_text()))


def test_no_source_imports_jax_or_the_jax_package():
    for path in H.BENCH.rglob("*.py"):
        assert not _tops(path) & set(H.FORBIDDEN), path


def test_references_import_nothing_of_the_system():
    for path in (H.BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in _tops(path), path
        assert "repro_torch" not in path.read_text(), path


def test_no_fixed_paths_outside_the_checkout():
    for path in H.BENCH.rglob("*.py"):
        if path.name == "test_bench_imports.py":
            continue
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=H.ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{H.ROOT}:{H.ROOT / 'src'}", "PATH": "/usr/bin",
             "HOME": str(H.ROOT / "build")})
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_rehearsal_loads_no_forbidden_module():
    code = ("from bench import run as R\n"
            "from bench.tests.small import small_spec\n"
            "for c in ('agg.whisper-tiny.drop', 'train.whisper-tiny'):\n"
            "    out, _ = R.run_cell(c, small_spec(c), 3, 1.5, False, 'cpu')\n"
            "    assert out['correct']\n")
    loaded = _loaded(code)
    assert "repro_torch" in loaded
    assert not set(loaded) & set(H.FORBIDDEN)


def test_the_references_alone_load_nothing_of_the_system():
    loaded = _loaded("import bench.reference.agg, bench.reference.whisper, "
                     "bench.reference.jrandom, bench.reference.common")
    assert "repro_torch" not in loaded and "torch" in loaded
