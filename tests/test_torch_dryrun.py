"""The port's dry-run CLI (``python -m repro_torch.launch.dryrun``) against
the reference's ``tests/test_dryrun.py`` and ``repro.launch.lowering``.

- the reference's cases on the port's CLI (in this process: a pair runs
  on a fake process group, nothing is spawned): five pairs at ``--reduced
  --mesh 2,4``, the 3-axis ``--mesh 2,2,2``, the fsdp pair with
  ``{"client_parallel": false}`` and the recorded skip, with the same
  assertions; each line carries every key the reference's carries, but
  XLA's ``generated_code_size_in_bytes`` and ``alias_size_in_bytes``;
- the module entry point exits 0 with an ``[OK]`` line, and 1 with a
  ``[FAIL]`` line when a pair raises;
- every (arch, shape) pair's ``mesh``, ``m``, ``client_parallel``,
  ``model_flops`` and skip reason equal the reference's on the production
  mesh (the reference's builders on an ``AbstractMesh``; nothing lowered);
- the per-device FLOPs of qwen2-1.5b's reduced decode_32k and train_4k on
  a 1 x 1 mesh, against the reference lowered in this process.  XLA counts
  every elementwise op of its fused module once and the port counts each
  eager op, with K10's operations from its bound; measured on the CPU
  (torch 2.13, jax 0.9.0): port / reference 0.58 for the decode (XLA also
  counts the cache update and the mask as flops; the port's ring write is
  a copy) and 1.11 for the round (the port's int64 modular sums and
  Threefry in torch ops); held within [0.5, 1.25].
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import dryrun
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
FLOPS_BAND = (0.5, 1.25)

# the reference's keys (repro.launch.lowering.lower_pair) that torch can
# fill
TOP_KEYS = {"arch", "shape", "mesh", "reduced", "mode", "memory",
            "roofline", "lower_compile_s"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "peak_bytes_est"}
ROOFLINE_KEYS = {"flops_per_device", "bytes_per_device", "collectives",
                 "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "bound_time_s", "model_flops", "useful_flops_ratio",
                 "cost_probe_multiplier"}
COLLECTIVE_KEYS = {"ops", "total_bytes", "total_wire_bytes", "count"}


def run_dryrun(args, tmp_path, name="r.jsonl"):
    out = tmp_path / name
    rc = dryrun.main(args + ["--out", str(out)])
    return rc, json.loads(out.read_text().strip().splitlines()[-1])


def _has_reference_keys(res):
    assert TOP_KEYS <= set(res), TOP_KEYS - set(res)
    assert MEMORY_KEYS <= set(res["memory"])
    assert ROOFLINE_KEYS <= set(res["roofline"])
    assert COLLECTIVE_KEYS <= set(res["roofline"]["collectives"])
    assert "replicated_regions" in res
    if res["mode"] == "train":
        assert {"m", "client_parallel"} <= set(res)


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", "train_4k"),          # dense + FL round
    ("deepseek-moe-16b", "train_4k"),    # expert parallelism
    ("mamba2-780m", "long_500k"),        # SSM decode, constant state
    ("recurrentgemma-2b", "decode_32k"),  # hybrid ring cache
    ("whisper-tiny", "prefill_32k"),     # enc-dec
])
def test_dryrun_single_pod(arch, shape, tmp_path):
    rc, res = run_dryrun(["--arch", arch, "--shape", shape, "--reduced",
                          "--mesh", "2,4"], tmp_path)
    assert rc == 0, res
    assert "error" not in res, res
    assert res["roofline"]["flops_per_device"] > 0
    assert res["memory"]["peak_bytes_est"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
    _has_reference_keys(res)


def test_dryrun_multi_pod_axis(tmp_path):
    """The 'pod' axis must shard: 3-axis mesh (pod, data, model)."""
    rc, res = run_dryrun(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                          "--reduced", "--mesh", "2,2,2"], tmp_path)
    assert rc == 0, res
    assert "error" not in res, res
    assert res["mesh"] == {"pod": 2, "data": 2, "model": 2}
    # the clients' one reduction over (pod, data) on top of the probe's
    assert res["roofline"]["collectives"]["ops"]["all-reduce"]["count"] > 0


def test_dryrun_fsdp_sequential_mode(tmp_path):
    """cfg.fsdp archs use the sequential-client path (client_parallel=False)."""
    rc, res = run_dryrun(["--arch", "deepseek-7b", "--shape", "train_4k",
                          "--mesh", "2,4", "--reduced",
                          "--opts", '{"client_parallel": false}'], tmp_path)
    assert rc == 0, res
    assert "error" not in res, res
    assert res["client_parallel"] is False


def test_dryrun_skip_recorded(tmp_path):
    rc, res = run_dryrun(["--arch", "whisper-tiny", "--shape", "long_500k",
                          "--mesh", "2,4", "--reduced"], tmp_path)
    assert rc == 0
    assert "skipped" in res


def test_dryrun_module_entry_point(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "r.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "train_4k", "--reduced", "--mesh", "2,4",
         "--out", str(out)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[OK] qwen2-1.5b x train_4k" in r.stdout
    _has_reference_keys(json.loads(out.read_text().splitlines()[-1]))


def test_dryrun_failure_exits_1(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import lowering

    def broken(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(lowering, "lower_pair", broken)
    rc, res = run_dryrun(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                          "--reduced", "--mesh", "1,1"], tmp_path)
    assert rc == 1
    assert res["error"] == "boom" and "RuntimeError" in res["traceback"]
    assert "[FAIL] qwen2-1.5b x decode_32k" in capsys.readouterr().out


def test_every_pair_matches_the_reference_header():
    """mesh, m, client_parallel, model_flops and the skip of every pair on
    the production mesh, against the reference's builders on an abstract
    16 x 16 mesh (nothing lowered)."""
    from jax.sharding import AbstractMesh

    from repro.configs import registry as jreg
    from repro.launch import lowering as jlow
    from repro_torch.configs import registry as treg
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import lowering as tlow
    from repro_torch.launch.mesh import make_production_mesh
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    tmesh = make_production_mesh()
    n = 0
    for arch in treg.ARCH_IDS:
        for shape in SHAPES:
            got = tlow.lower_pair(arch, shape, tmesh, compile_=False)
            jcfg = jreg.config_for_pair(arch, shape)
            if jcfg is None:
                assert got == {"arch": arch, "shape": shape,
                               "skipped": jreg.SKIPS[(arch, shape)]}
                continue
            assert got["mesh"] == dict(jmesh.shape) == {"data": 16,
                                                         "model": 16}
            jshape = jreg.get_shape(shape)
            fl = None
            if jshape.mode == "train":
                _, _, meta = jlow.build_train(jcfg, jshape, jmesh)
                assert (got["m"], got["client_parallel"]) == (
                    meta["m"], meta["client_parallel"]), (arch, shape)
                fl = meta["fl_cfg"]
            tcfg = treg.config_for_pair(arch, shape)
            assert tlow._model_flops(tlow._prep_cfg(tcfg, {}),
                                     treg.get_shape(shape), fl) == \
                jlow._model_flops(jlow._prep_cfg(jcfg, {}), jshape, fl), \
                (arch, shape)
            n += 1
    assert n == len(treg.ARCH_IDS) * len(SHAPES) - len(treg.SKIPS)


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_per_device_flops_against_the_reference(shape):
    from repro.launch import lowering as jlow
    from repro.launch.mesh import make_mesh_compat as jmesh
    from repro_torch.launch import lowering as tlow
    from repro_torch.launch.mesh import make_mesh_compat as tmesh
    want = jlow.lower_pair("qwen2-1.5b", shape,
                           jmesh((1, 1), ("data", "model")), reduced=True)
    got = tlow.lower_pair("qwen2-1.5b", shape,
                          tmesh((1, 1), ("data", "model")), reduced=True)
    w, g = want["roofline"], got["roofline"]
    assert g["model_flops"] == w["model_flops"]
    assert g.get("cost_probe_multiplier") == w["cost_probe_multiplier"]
    ratio = g["flops_per_device"] / w["flops_per_device"]
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
