"""The cost harness's counting and its roofline (``repro_torch.launch.
analysis``), against the reference's ``repro.launch.analysis``.

- the collectives a program issues on a fake process group of 16 ranks
  summarise, through ``collective_summary``, to the reference's summary of
  ``tests/test_sharding.py``'s HLO text (the same kinds, bytes, wire bytes
  and count);
- with the module's rates patched to the reference's TPU figures,
  ``roofline`` of the same counts is the reference's dict;
- the H100 rates live in one place: ``chip_smoke.py``'s kernel bounds are
  ``analysis.kernel_bound_ms``'s;
- K3, K6, K7, K8 and K10, called on meta or fake tensors, launch nothing,
  return their output's shape and dtype and add the operations and bytes
  of their bounds (``PERF.md``); on CPU tensors they still run the plain
  version; K10 over a cache split by slots combines with an all-reduce;
- ``CostMode`` counts a matmul by dtype, moves no bytes for a view, reads
  only the rows a gather picks, and tracks the peak of what it creates;
- the depth probe's extrapolation equals the whole stack's count, and two
  runs of one step on a fake mesh count alike;
- ``attn_seq_shard`` changes nothing on one device and, on a mesh, splits
  the decode attention's cache slots over ``model`` (K10's partial rows
  combined by one all-reduce a layer).
"""
import math
from pathlib import Path

import pytest
import torch

from repro_torch.launch import analysis, lowering
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]

HLO = """
  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %x), replica_groups={}
  %ag.1 = bf16[512]{0} all-gather(bf16[32]{0} %y), dimensions={0}
  %rs = (f32[128]{0}, f32[128]{0}) reduce-scatter(f32[2048]{0} %z), dimensions={0}
  %cp = u32[16]{0} collective-permute(u32[16]{0} %w), source_target_pairs={{0,1}}
  %nothing = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)
"""


def test_collective_summary_matches_the_reference_hlo():
    from repro.launch import analysis as ref
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with lowering.fake_world((16,), ("model",)) as mesh:
        dm = mesh.device_mesh
        with analysis.CostMode() as cm:
            # a partial sum made whole: an all-reduce of f32[1024, 256]
            x = DTensor.from_local(torch.empty(1024, 256), dm, [Partial()],
                                   run_check=False)
            x.redistribute(dm, [Replicate()])
            # a split bf16[512] made whole: an all-gather from bf16[32]
            y = DTensor.from_local(torch.empty(32, dtype=torch.bfloat16), dm,
                                   [Shard(0)], run_check=False)
            y.redistribute(dm, [Replicate()])
            # two f32[2048] partial sums split at once: one reduce-scatter
            # with two f32[128] results
            for t in funcol.reduce_scatter_tensor_coalesced(
                    [torch.empty(2048), torch.empty(2048)], "sum", [0, 0],
                    (dm, 0)):
                funcol.wait_tensor(t)
            # each rank's 16 words to the next rank
            funcol.wait_tensor(funcol.permute_tensor(
                torch.empty(16, dtype=torch.int32),
                [(r + 1) % 16 for r in range(16)], (dm, 0)))
    assert analysis.collective_summary(cm.counts.collectives) == \
        ref.collective_summary(HLO)
    assert [r["kind"] for r in cm.counts.collectives] == [
        "all-reduce", "all-gather", "reduce-scatter", "collective-permute"]


def test_loop_records_scale_by_the_multiplier():
    recs = [{"op": "all_reduce", "bytes": 100, "in_entry": True},
            {"op": "all_gather_into_tensor", "bytes": 10,
             "in_entry": False}]
    s = analysis.collective_summary(recs, loop_multiplier=4.0)
    assert s["total_bytes"] == 100 + 40
    assert s["total_wire_bytes"] == 200 + 40
    assert s["ops"]["all-gather"]["count"] == 1


def test_roofline_terms_math(monkeypatch):
    """The reference's test, with this module's rates patched to the
    reference's TPU v5e figures: the same dict for the same counts."""
    from repro.launch import analysis as ref

    class FakeCompiled:
        def cost_analysis(self):
            return {"flops": 197e12, "bytes accessed": 819e9}

    hlo = "%ar = f32[125000000]{0} all-reduce(f32[125000000]{0} %x)"
    want = ref.roofline(FakeCompiled(), hlo, model_flops=197e12 * 2,
                        chips=2)
    for name, v in (("PEAK_FLOPS", ref.PEAK_FLOPS), ("HBM_BW", ref.HBM_BW),
                    ("LINK_BW", ref.ICI_BW)):
        monkeypatch.setattr(analysis, name, v)
    counts = analysis.Counts(
        matmul_flops={"bfloat16": 197e12}, bytes=819e9,
        collectives=[{"op": "all_reduce", "bytes": 125_000_000 * 4,
                      "in_entry": True}])
    got = analysis.roofline(counts, model_flops=197e12 * 2, chips=2)
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k] == (pytest.approx(v) if isinstance(v, float) else v), k
    assert got["t_compute_s"] == pytest.approx(1.0)
    assert got["t_collective_s"] == pytest.approx(2 * 5e8 / 50e9)


def test_compute_term_splits_by_rate():
    c = analysis.Counts(matmul_flops={"bfloat16": analysis.PEAK_FLOPS,
                                      "float32": analysis.F32_FLOPS},
                        float_ops=analysis.F32_FLOPS,
                        int_ops=analysis.INT_OPS_PER_S)
    r = analysis.roofline(c)
    assert r["compute_terms"]["matmul_s"] == pytest.approx(2.0)
    assert r["compute_terms"]["float_s"] == pytest.approx(1.0)
    assert r["compute_terms"]["integer_s"] == pytest.approx(1.0)
    assert r["t_compute_s"] == pytest.approx(4.0)
    assert r["dominant"] == "compute"


def test_the_card_rates_live_in_one_place(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    src = (ROOT / "chip_smoke.py").read_text()
    for literal in ("3.35e12", "67e12", "1.98e9", "THREEFRY_OPS = "):
        assert literal not in src
    monkeypatch.setattr(analysis, "INT_OPS_PER_S", analysis.INT_OPS_PER_S)
    assert analysis.set_int_rate(132, 1980) == pytest.approx(33.454e12,
                                                             rel=1e-4)
    for ops, nbytes, integer in ((2 * 4 * 10 ** 8, 16 * 10 ** 8, False),
                                 (10 ** 12, 10 ** 6, True),
                                 (10 ** 13, 10 ** 6, False)):
        e = chip_smoke._entry("k", "src", "ref", 1, 1.0, 1.0, ops, nbytes,
                              integer=integer)
        assert (e["bound_ms"], e["bound_by"]) == analysis.kernel_bound_ms(
            ops, nbytes, integer=integer)
    # K3 at the round's leaf, as PERF.md's table gives it
    b, by = analysis.kernel_bound_ms(2 * 4 * 385_351_680,
                                     4 * 385_351_680 * 4 + 16)
    assert (round(b, 3), by) == (1.840, "bytes")


# ---------------------------------------------------------------------------
# the kernels' cost hooks
# ---------------------------------------------------------------------------
def _k10_args(make, B=2, H=4, KV=2, hd=32, W=48, dtype=torch.float32):
    return (make((B, H, hd), torch.float32), make((B, W, KV, hd), dtype),
            make((B, W, KV, hd), dtype), make((W,), torch.int32))


def _cases():
    from repro_torch.kernels import dp_clip as kdp
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import secure_agg as ksa
    C, D = 3, 1000
    B, H, KV, hd, W = 2, 4, 2, 32, 48
    return {
        "sq_norms": (kdp.sq_norms, lambda m: (m((C, D), torch.float32),),
                     (C,), torch.float32, 2 * C * D, C * D * 4 + C * 4),
        "scale_accum": (kdp.scale_accum,
                        lambda m: (m((C, D), torch.float32),
                                   m((C,), torch.float32)),
                        (D,), torch.float32, 2 * C * D,
                        C * D * 4 + C * 4 + D * 4),
        "quantize_mask": (lambda x, k, u: ksa.quantize_mask(x, k, u, 3.0,
                                                            math.inf),
                          lambda m: (m((D,), torch.float32),
                                     m((D,), torch.int32),
                                     m((D,), torch.float32)),
                          (D,), torch.int32, 8 * D, 16 * D),
        "quantize_mask_nomask": (
            lambda x, u: ksa.quantize_mask(x, None, u, 3.0, math.inf),
            lambda m: (m((D,), torch.float32), m((D,), torch.float32)),
            (D,), torch.int32, 8 * D, 12 * D),
        "dequantize": (lambda q: ksa.dequantize(q, 0.5),
                       lambda m: (m((D,), torch.int32),), (D,),
                       torch.float32, D, 8 * D),
        "flash_decode": (lambda q, k, v, s: kfd.flash_decode(q, k, v, s,
                                                             W - 1),
                         lambda m: _k10_args(m, B, H, KV, hd, W),
                         (B, H, hd), torch.float32,
                         4 * B * H * W * hd + 5 * B * H * W,
                         2 * B * W * KV * hd * 4 + 2 * B * H * hd * 4
                         + W * 4),
    }


def _counters(name):
    from repro_torch import testing
    key = "quantize_mask" if name.startswith("quantize_mask") else name
    return testing.kernel_counts()[key]


@pytest.mark.parametrize("where", ["meta", "fake"])
@pytest.mark.parametrize("name", sorted(_cases()))
def test_kernel_hooks_report_their_bounds(name, where):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, make_args, shape, dtype, ops, nbytes = _cases()[name]
    before = dict(_counters(name))
    mode = FakeTensorMode() if where == "fake" else None

    def make(s, dt):
        return torch.empty(s, dtype=dt, device="meta" if mode is None
                           else "cpu")

    with (mode or torch.device("meta")):
        args = make_args(make)
        with analysis.CostMode() as cm:
            out = fn(*args)
    assert tuple(out.shape) == shape and out.dtype == dtype
    kname = "quantize_mask" if name.startswith("quantize_mask") else name
    k = cm.counts.kernels[kname]
    assert (k["calls"], k["ops"], k["bytes"]) == (1, ops, nbytes)
    assert cm.counts.float_ops == ops and cm.counts.bytes == nbytes
    assert _counters(name) == before  # no launch, no plain call


@pytest.mark.parametrize("name", sorted(_cases()))
def test_kernel_wrappers_on_cpu_still_run_the_plain_version(name):
    fn, make_args, shape, dtype, _, _ = _cases()[name]
    g = torch.Generator().manual_seed(0)

    def make(s, dt):
        if dt == torch.int32:
            return torch.randint(-5, 5, s, generator=g, dtype=dt)
        return torch.rand(s, generator=g, dtype=dt)

    before = _counters(name)["plain_calls"]
    with analysis.CostMode() as cm:
        out = fn(*make_args(make))
    assert tuple(out.shape) == shape and out.dtype == dtype
    assert _counters(name)["plain_calls"] == before + 1
    assert not cm.counts.kernels  # the plain version's own ops instead


def test_k10_over_a_slot_split_cache_combines_with_an_all_reduce():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import flash_decode as kfd
    B, H, KV, hd, W = 2, 4, 2, 32, 48
    with lowering.fake_world((2,), ("model",)) as mesh:
        dm = mesh.device_mesh
        q = DTensor.from_local(torch.empty(B, H, hd), dm, [Replicate()],
                               run_check=False)
        k, v = (DTensor.from_local(torch.empty(B, W // 2, KV, hd), dm,
                                   [Shard(1)], run_check=False)
                for _ in range(2))
        slot = DTensor.from_local(torch.empty(W // 2, dtype=torch.int32), dm,
                                  [Shard(0)], run_check=False)
        with analysis.CostMode() as cm:
            out = kfd.flash_decode(q, k, v, slot, W - 1)
    assert isinstance(out, DTensor) and out.placements == (Replicate(),)
    assert tuple(out.shape) == (B, H, hd)
    # this rank's half of the slots, then the partial rows summed
    assert cm.counts.kernels["flash_decode"]["ops"] == \
        4 * B * H * (W // 2) * hd + 5 * B * H * (W // 2)
    assert [(r["kind"], r["bytes"]) for r in cm.counts.collectives] == [
        ("all-reduce", B * H * hd * 4)]


# ---------------------------------------------------------------------------
# CostMode and the probes
# ---------------------------------------------------------------------------
def test_cost_mode_counts_matmuls_views_gathers_and_the_peak():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(64, 32, dtype=torch.bfloat16)
        b = torch.empty(32, 16, dtype=torch.bfloat16)
        table = torch.empty(1000, 16)
        idx = torch.zeros(5, dtype=torch.long)
        with analysis.CostMode() as cm:
            c = a @ b  # 2*64*32*16 flops; reads a, b; writes c
            c.t().reshape(16, 64)  # a view: nothing
            del c
            rows = torch.nn.functional.embedding(idx, table)
    counts = cm.counts
    assert counts.matmul_flops == {"bfloat16": 2 * 64 * 32 * 16}
    mm_bytes = (64 * 32 + 32 * 16 + 64 * 16) * 2
    assert counts.bytes == mm_bytes + 2 * 5 * 16 * 4 + 5 * 8
    assert counts.float_ops == 5 * 16
    assert cm.peak_bytes == 64 * 16 * 2 and cm.live_bytes == 5 * 16 * 4
    del rows


def test_memory_summary_keys():
    m = analysis.memory_summary(analysis.MemoryCounts(100, 10, 150))
    assert m == {"argument_size_in_bytes": 100, "output_size_in_bytes": 10,
                 "temp_size_in_bytes": 40, "peak_bytes_est": 150}


@pytest.mark.parametrize("arch,layers", [("qwen2-1.5b", 5),
                                         ("recurrentgemma-2b", 7),
                                         ("deepseek-moe-16b", 5)])
def test_the_depth_probe_equals_the_whole_stack(arch, layers):
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    cfg = registry.get_config(arch, reduced=True)
    pattern = cfg.block_pattern
    cfg = cfg.with_overrides(num_layers=layers, block_pattern=None if
                             pattern is None else tuple(
                                 pattern[i % len(pattern)]
                                 for i in range(layers)))
    shape = ShapeConfig("d", 32, 2, "decode")
    whole, none = lowering.run_step(lowering.build_decode, cfg, shape,
                                    depth_probe=False)
    probe, depths = lowering.run_step(lowering.build_decode, cfg, shape)
    assert none is None and depths and max(depths) < layers
    a, b = whole.counts, probe.counts
    assert b.matmul_flops == pytest.approx(a.matmul_flops)
    assert (b.float_ops, b.int_ops, b.bytes) == pytest.approx(
        (a.float_ops, a.int_ops, a.bytes))
    assert b.kernels["flash_decode"]["calls"] == pytest.approx(
        a.kernels["flash_decode"]["calls"])
    assert probe.memory.argument_bytes == whole.memory.argument_bytes


def test_two_runs_on_a_fake_mesh_count_alike():
    """DTensor works out each op's output shape once per layout on
    whole-size fake tensors; that run is not counted, so a step's second
    run counts what its first did."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    shape = ShapeConfig("d", 64, 8, "decode")
    runs = [lowering.run_step(lowering.build_decode, cfg, shape, (2, 4),
                              depth_probe=False)[0] for _ in range(2)]
    a, b = (r.counts for r in runs)
    assert (a.matmul_flops, a.float_ops, a.int_ops, a.bytes) == \
        (b.matmul_flops, b.float_ops, b.int_ops, b.bytes)
    assert len(a.collectives) == len(b.collectives) > 0


def test_attn_seq_shard_is_a_layout_only():
    from repro_torch.launch.mesh import make_mesh_compat
    counts = {}
    for mesh in ((1, 1), (2, 4)):
        for seq in (False, True):
            r = lowering.lower_pair(
                "qwen2-1.5b", "decode_32k",
                make_mesh_compat(mesh, ("data", "model")), reduced=True,
                opts={"attn_seq_shard": seq})
            counts[mesh, seq] = r["roofline"]
    one, split = counts[(1, 1), False], counts[(1, 1), True]
    assert (one["flops_per_device"], one["bytes_per_device"]) == \
        (split["flops_per_device"], split["bytes_per_device"])
    k10 = {seq: counts[(2, 4), seq]["kernels"]["flash_decode"]
           for seq in (False, True)}
    ar = {seq: counts[(2, 4), seq]["collectives"]["ops"]["all-reduce"]
          for seq in (False, True)}
    assert k10[True]["calls"] == k10[False]["calls"] == 2  # 2 layers
    assert ar[True]["count"] == ar[False]["count"] + 2  # one a layer
