"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skips without a GPU (the kernels have no CPU mode).  This
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import round as fl_round
from repro_torch.core.analytics import bitagg as fa
from repro_torch.core.fl import secure_agg as sa
from repro_torch.kernels import bitagg as k9
from repro_torch.kernels import dp_clip as kdp
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import prf
from repro_torch.kernels import row_sum as krs
from repro_torch.kernels import secure_agg as ksa
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.testing import (PAIR_SUM_CARD_CASES, PAIR_SUM_CASES,
                                 ROW_SUM_CASES, pair_sum_case,
                                 pin_cpu_threads, row_sum_case)

pin_cpu_threads()

SCALE = 1.0e4 / 3.0
UW = (77, 0xDEADBEEF)


def _session(n, degree, perm=None, offset=0):
    nbrs = None if perm is None else sa.neighbor_table(n, degree, perm,
                                                       device="cuda")
    return ksa.SessionMeta(key_words=(0x1234, 0x5A5E), num_slots=n,
                           degree=degree, slot_offset=offset, neighbors=nbrs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(100_003, generator=g, device=cuda) * 0.01
    ksa.reset_counts()
    for n, degree, perm in ((8, 0, None), (10, 4, None),
                            (10, 4, [3, 0, 9, 1, 4, 8, 2, 7, 6, 5])):
        s = _session(n, degree, perm)
        got = ksa.quantize_mask_prf(x, SCALE, 2, UW, s, u_offset=9)
        want = ksa.quantize_mask_prf_plain(x, SCALE, 2, UW, s, u_offset=9)
        assert torch.equal(got, want)
    # uniform stream positions past 2^32 (64-bit, as the plain version)
    s = _session(8, 0)
    got = ksa.quantize_mask_prf(x, SCALE, 2, UW, s, u_offset=(1 << 32) - 3)
    assert torch.equal(got, ksa.quantize_mask_prf_plain(
        x, SCALE, 2, UW, s, u_offset=(1 << 32) - 3))
    xs = torch.randn(8, 5001, generator=g, device=cuda) * 0.01
    ws = torch.rand(8, generator=g, device=cuda)
    us = prf.uniform_block(1, 2, 8 * 5001, device=cuda).reshape(8, 5001)
    for kw in ({}, {"session": _session(8, 0)},
               {"session": _session(10, 4, offset=3)}):
        got = ksa.weighted_quantize_accum(xs, ws, us, SCALE, **kw)
        want = ksa.weighted_quantize_accum_plain(xs, ws, us, SCALE, **kw)
        assert torch.equal(got, want)
    # K4 at ragged and whole Hadamard blocks, nonzero uniform offsets
    for D, scale, u_off in ((1, SCALE, 0), (511, 131067.5, 4097),
                            (100_003, 16777215.6875, 1 << 20),
                            (4097, SCALE, (1 << 32) - 3)):
        x = torch.randn(D, generator=g, device=cuda) * 0.01
        got = ksa.rotate_quantize_prf(x, scale, (0x1234, 0xCB01), UW,
                                      u_offset=u_off)
        want = ksa.rotate_quantize_prf_plain(x, scale, (0x1234, 0xCB01), UW,
                                             u_offset=u_off)
        assert torch.equal(got, want)
    # K5 at three widths, a ragged size, both directions
    for bits in (1, 19, 31):
        q = torch.randint(0, 2 ** bits, (10_007,), generator=g, device=cuda,
                          dtype=torch.int64).to(torch.int32)
        words = ksa.pack_residues(q, bits)
        assert torch.equal(words, ksa.pack_residues_plain(q, bits))
        back = ksa.unpack_residues(words, 10_007, bits)
        assert torch.equal(back, ksa.unpack_residues_plain(words, 10_007,
                                                           bits))
        assert torch.equal(back, q)
    assert ksa.counts() == {
        "quantize_mask_prf": {"launches": 4, "plain_calls": 0},
        "weighted_quantize_accum": {"launches": 1, "plain_calls": 0},
        ksa.PRF_LANE: {"launches": 2, "plain_calls": 0},
        "rotate_quantize_prf": {"launches": 4, "plain_calls": 0},
        "pack_residues": {"launches": 3, "plain_calls": 0},
        "unpack_residues": {"launches": 3, "plain_calls": 0},
        "quantize_mask": {"launches": 0, "plain_calls": 0},
        "dequantize": {"launches": 0, "plain_calls": 0}}


def paired_prf_sessions(device):
    """Graphs for the paired K1/K2: the 8-slot complete graph of the main
    path (keys in registers), other complete graphs, rings and a table
    (keys in shared memory), up to MAX_KERNEL_NEIGHBORS neighbours."""
    big = ksa.MAX_KERNEL_NEIGHBORS
    perm = [3, 0, 9, 1, 4, 8, 2, 7, 6, 5]
    return {
        "complete8": _session(8, 0),
        "complete3": _session(3, 0),
        "complete10": _session(10, 0),
        "ring10": _session(10, 4),
        "table10": ksa.SessionMeta(
            key_words=(11, 13), num_slots=10, degree=4,
            neighbors=sa.neighbor_table(10, 4, perm, device=device)),
        f"complete{big}": _session(big, 0),
        f"ring{big + 2}x{big}": _session(big + 2, big),
    }


@pytest.mark.cuda
def test_cuda_paired_prf_kernels_match_plain_versions(cuda):
    """K1 and K2's PRF lane walk element pairs (one Threefry per counter,
    both words used): bit-equal at odd and even n (1, 2, 3, ...), odd and
    even uniform offsets, unaligned inputs, every graph kind, and K2 shards
    whose rows cross num_slots."""
    g = torch.Generator(device=cuda).manual_seed(4)
    sessions = paired_prf_sessions(cuda)
    big = ksa.MAX_KERNEL_NEIGHBORS
    ksa.reset_counts()
    launches = 0
    for name, s in sessions.items():
        sizes = (1, 2, 3, 5, 8, 1001) if s.num_slots > 10 else \
            (1, 2, 3, 4, 5, 7, 8, 1000, 4097)
        for n in sizes:
            x = torch.randn(n + 1, generator=g, device=cuda) * 0.01
            for xs in (x[:n], x[1:]):  # aligned, and 4 bytes off
                for slot in {0, s.num_slots // 2, s.num_slots - 1}:
                    for u_off in (0, 1, 2, 3, 12345):
                        got = ksa.quantize_mask_prf(xs, SCALE, slot, UW, s,
                                                    u_offset=u_off)
                        want = ksa.quantize_mask_prf_plain(
                            xs, SCALE, slot, UW, s, u_offset=u_off)
                        assert torch.equal(got, want), (name, n, slot, u_off)
                        launches += 1
    assert ksa.quantize_mask_prf.launches == launches
    launches = 0
    for name, s in sessions.items():
        shapes = ((2, 5), (3, 1001)) if s.num_slots > 10 else \
            ((1, 1), (8, 2), (8, 3), (5, 1000), (8, 4097), (3, 4096))
        for C, D in shapes:
            xs = torch.randn(C, D, generator=g, device=cuda) * 0.01
            ws = torch.rand(C, generator=g, device=cuda)
            us = prf.uniform_block(1, 2, C * D, device=cuda).reshape(C, D)
            # shards: rows at slots offset.., the ones past the session
            # carry no mask
            for off in {0, 3, s.num_slots - 2, s.num_slots - 1}:
                kw = {"session": s._replace(slot_offset=off)}
                got = ksa.weighted_quantize_accum(xs, ws, us, SCALE, **kw)
                want = ksa.weighted_quantize_accum_plain(xs, ws, us, SCALE,
                                                         **kw)
                assert torch.equal(got, want), (name, C, D, off)
                launches += 1
    assert ksa.weighted_quantize_accum.prf_launches == launches
    assert big in {int(s.num_slots) for s in sessions.values()}


@pytest.mark.cuda
def test_cuda_normal_randint_and_init_match_the_cpu(cuda):
    """The rebuilt jax.random draws give the same bits on the card as on
    the CPU (every op of normal is IEEE-rounded on both), and so does the
    dense family's init."""
    for seed, shape in ((0, (1 << 20,)), (7, (1000, 3)), (123, (1,))):
        key = prf.fold_in(prf.PRNGKey(seed), 3)
        assert torch.equal(prf.normal(key, shape, device=cuda).cpu(),
                           prf.normal(key, shape))
        assert torch.equal(
            prf.randint(key, shape, 0, 151_936, device=cuda).cpu(),
            prf.randint(key, shape, 0, 151_936))
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    got = build_model(cfg, device=cuda).init(prf.PRNGKey(2))
    want = build_model(cfg, device="cpu").init(prf.PRNGKey(2))
    for a, b in zip(T.leaves(want), T.leaves(got)):
        assert torch.equal(b.cpu(), a)


# jax.random draws through csrc/jax_random.cu: small and odd lengths on
# several keys; whisper-tiny's largest leaf and a length past 2^25
DRAW_KEYS = tuple(prf.fold_in(prf.PRNGKey(s), 11) for s in (0, 7, 0x5A5E))
DRAW_SMALL = (1, 3, 4097, (1 << 16) + 1)
DRAW_LARGE = (51_865 * 384, (1 << 25) + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_bits", "uniform", "normal"])
def test_cuda_jax_draw_matches_the_cpu_path(cuda, name):
    """One launch a draw, bit-equal to the CPU's tile loop on every key and
    length; normal's draws cross log1p's |u| = sqrt(2) - 1 edge and
    erf_inv's w = 5 edge (|z| ~0.545 and ~2.93) on each key."""
    draw = getattr(prf, name)
    for key in DRAW_KEYS:
        for n in DRAW_SMALL:
            launches = prf._draw.launches
            got = draw(key, (n,), device=cuda)
            assert prf._draw.launches == launches + 1
            want = draw(key, (n,))
            assert got.dtype == want.dtype
            assert torch.equal(got.cpu(), want), (key, n)
        if name == "normal":
            z = want.abs()
            for edge in (0.545, 2.93):
                assert bool((z < 0.98 * edge).any())
                assert bool((z > 1.02 * edge).any())


@pytest.mark.cuda
def test_cuda_jax_draws_match_the_cpu_at_full_size(cuda):
    """At whisper-tiny's largest leaf and past 2^25 elements: the bits
    against the CPU's, uniform and normal against the CPU's finish of those
    bits (normal's is a function of ``w >> 9`` alone, tabulated over all
    2^23 values, itself checked against a CPU draw)."""
    units = torch.arange(1 << 23, dtype=torch.int64) << 9
    table = prf._normal_finish(units)
    key = DRAW_KEYS[1]
    bits = prf.random_bits(key, (4097,))
    assert torch.equal(table[bits >> 9], prf.normal(key, (4097,)))
    for n in DRAW_LARGE:
        bits = prf.random_bits(key, (n,))
        assert torch.equal(prf.random_bits(key, (n,), device=cuda).cpu(),
                           bits)
        assert torch.equal(prf.uniform(key, (n,), device=cuda).cpu(),
                           prf._unit(bits))
        assert torch.equal(prf.normal(key, (n,), device=cuda).cpu(),
                           table[bits >> 9])


@pytest.mark.cuda
def test_cuda_randint_and_permutation_go_through_the_draw_kernel(cuda):
    """randint draws two words a element (two launches), permutation one
    word a sort round; both bit-equal to the CPU's."""
    key = DRAW_KEYS[2]
    launches = prf._draw.launches
    got = prf.randint(key, (8, 2048), 0, 151_936, device=cuda)
    assert prf._draw.launches == launches + 2
    assert torch.equal(got.cpu(), prf.randint(key, (8, 2048), 0, 151_936))
    n = 5000  # past 1625: two sort rounds
    launches = prf._draw.launches
    got = prf.permutation(key, n, device=cuda)
    assert prf._draw.launches == launches + 2
    assert torch.equal(got.cpu(), prf.permutation(key, n))


@pytest.mark.cuda
def test_cuda_jax_draw_runs_no_torch_op(cuda):
    """A draw on the card is its output's allocation and one launch: no
    int64 torch op, no host tile, one prf_device_draws."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import telemetry as tele

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    tel = tele.Telemetry(record_spans=False)
    prev = tele.set_default(tel)
    try:
        with Ops() as ops:
            prf.normal(DRAW_KEYS[0], (3, 4097), device=cuda)
    finally:
        tele.set_default(prev)
    assert set(ops.names) <= {"empty", "view", "_unsafe_view", "reshape"}, \
        ops.names
    assert tel.value("prf_device_draws", rounds=20) == 1
    assert tel.total("prf_host_tiles") == 0


@pytest.fixture
def default_registry():
    """A fresh process registry, the previous one restored after."""
    from repro_torch.core import telemetry as tele
    tel = tele.Telemetry(record_spans=False)
    prev = tele.set_default(tel)
    try:
        yield tel
    finally:
        tele.set_default(prev)


def _row_sum_on_card(rows, gate, tel):
    """``sum_rows`` on the card, with the launches and rows it counted."""
    launches, plain = krs.sum_rows.launches, krs.sum_rows.plain_calls
    rows0 = tel.total("modsum_device_rows")
    got = agg.sum_rows(rows, gate)
    torch.cuda.synchronize()
    assert krs.sum_rows.plain_calls == plain
    return (got, krs.sum_rows.launches - launches,
            tel.total("modsum_device_rows") - rows0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ROW_SUM_CASES)
def test_cuda_row_sum_matches_the_cpu_path(cuda, default_registry, name):
    """D2 bit-equal to the CPU's int64 loop: wrapping sums, gates of all /
    no / some rows, launches of at most 64 gated rows (65 and 129 gated
    rows take 2 and 3), a base 12 bytes past 16-byte alignment, stepped
    and padded rows, an odd width, rows of several dims."""
    rows, gate = row_sum_case(name, cuda)
    got, launches, counted = _row_sum_on_card(rows, gate, default_registry)
    want = agg.sum_rows(rows.cpu(), gate)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)
    n = sum(1 for b in range(rows.shape[0]) if gate is None or gate[b])
    assert launches == max(1, -(-n // krs.ROW_GROUP))
    assert counted == n


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [(1 << 30) + 8, (1 << 30) + 7])
def test_cuda_row_sum_offsets_past_2_31(cuda, default_registry, stride):
    """Rows whose element offsets pass 2^31 (one row stride of 2^30 + 8
    words, 16-byte aligned, and of 2^30 + 7, not): equal to the CPU's."""
    D = 4099
    g = torch.Generator(device=cuda).manual_seed(stride)
    big = torch.randint(-2 ** 31, 2 ** 31, (2 * stride + D,), generator=g,
                        dtype=torch.int32, device=cuda)
    rows = big.as_strided((3, D), (stride, 1))
    assert 2 * stride > 2 ** 31
    got, launches, counted = _row_sum_on_card(rows, None,
                                              default_registry)
    assert torch.equal(got.cpu(), agg.sum_rows(rows.cpu()))
    assert (launches, counted) == (1, 3)
    del big, rows
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_row_sum_refuses_strided_columns(cuda):
    """A row whose words are not contiguous raises: no copy, no launch."""
    rows = torch.zeros((4, 64), dtype=torch.int32, device=cuda)[:, ::2]
    launches = krs.sum_rows.launches
    with pytest.raises(ValueError, match="contiguous"):
        agg.sum_rows(rows)
    with pytest.raises(ValueError, match="int32"):
        agg.sum_rows(torch.zeros((4, 64), dtype=torch.int64, device=cuda))
    assert krs.sum_rows.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", PAIR_SUM_CASES + PAIR_SUM_CARD_CASES)
def test_cuda_pair_sum_matches_the_tile_loop(cuda, default_registry, name):
    """D3 bit-equal to the host tile loop, fresh and added into a row in
    place (the row's tail untouched): every CPU case (gains, graphs,
    lengths 0, 1, odd and ragged, a row 4 bytes past alignment, 400 pairs
    in two shared-memory stages) against the loop on the CPU; the drop
    cell's two sweeps (9 pairs over 2^25 and over 2,918,272 words) and a
    40-slot sweep against the same int64 loop run on the card.  One launch
    a call, counted by ``prf_device_pairs``; no tile loop on the card."""
    key, lo, hi, gains, length, row = pair_sum_case(name, cuda)
    pairs = sum(1 for x in gains if x != 0) if length else 0
    before = row.cpu()
    tel = default_registry
    launches = prf.signed_pair_sum.launches
    fresh = prf.signed_pair_sum(*key, lo, hi, gains, length, device=cuda)
    assert prf.signed_pair_sum(*key, lo, hi, gains, length, out=row) is row
    torch.cuda.synchronize()
    assert prf.signed_pair_sum.launches - launches == 2 * (pairs > 0)
    assert tel.total("prf_device_pairs") == 2 * pairs
    assert tel.total("prf_host_tiles") == 0
    on = "cpu" if name in PAIR_SUM_CASES else cuda
    want = prf.signed_pair_sum_plain(*key, lo, hi, gains, length, device=on)
    assert fresh.dtype == torch.int32 and fresh.shape == (length,)
    assert torch.equal(fresh.cpu(), want.cpu())
    want = torch.nn.functional.pad(want.cpu(), (0, before.numel() - length))
    assert torch.equal(row.cpu(), prf.to_int32(prf.words_of(before)
                                               + prf.words_of(want)))
    del fresh, row, want
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_recovering_flush_matches_the_cpu(cuda, default_registry):
    """A ``tee_stream`` session of 10 slots with one absent, flushed at
    the deadline on the card: the CPU's parameters bit for bit; the flush
    sweeps 9 pairs in each of the two chunks through D3 (18 pairs) and
    runs no tile loop."""
    from repro_torch.core.fl.async_fl import AsyncServer
    fl = FLConfig(clip_norm=1.0, server_lr=1.0, secure_agg_bits=32,
                  param_chunk_elems=2048)
    g = torch.Generator().manual_seed(9)
    params = {"w": torch.zeros(3000), "b": torch.zeros(700)}
    # norms ~0.6, inside the clip (an active clip's norm sums in another
    # order on the card)
    deltas = [{k: 0.01 * torch.randn(v.shape, generator=g)
               for k, v in params.items()} for _ in range(9)]
    tel = default_registry
    out = []
    for dev in ("cpu", cuda):
        srv = AsyncServer(params, fl, buffer_size=10, mask_mode="tee_stream",
                          staleness_mode="constant", device=dev)
        for d in deltas:
            srv.push({k: v.to(dev) for k, v in d.items()}, srv.version)
        assert srv.plan.num_chunks == 2
        tiles, pairs = tel.total("prf_host_tiles"), tel.total(
            "prf_device_pairs")
        assert srv.flush(force=True)
        torch.cuda.synchronize()
        out.append((srv.params, tel.total("prf_host_tiles") - tiles,
                    tel.total("prf_device_pairs") - pairs))
    (pc, tiles_cpu, pairs_cpu), (pg, tiles_card, pairs_card) = out
    assert all(torch.equal(a, b.cpu()) for a, b in zip(T.leaves(pc),
                                                       T.leaves(pg)))
    assert tiles_cpu > 0 and pairs_cpu == 0
    assert (tiles_card, pairs_card) == (0, 18)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_plain_version(cuda, dtype):
    """K10 on ragged W, a wrapped ring with a window, rep 6 and 10 (two
    row groups); f32 sums in another order: rtol = atol = 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(1)
    kfd.reset_counts()
    for B, H, KV, hd, W, window, pos in ((8, 12, 2, 128, 2080, 0, 2047),
                                         (2, 10, 1, 256, 300, 0, 180),
                                         (3, 8, 4, 64, 100, 64, 130)):
        q = torch.randn(B, H, hd, generator=g, device=cuda) * hd ** -0.5
        k = torch.randn(B, W, KV, hd, generator=g, device=cuda).to(dtype)
        v = torch.randn(B, W, KV, hd, generator=g, device=cuda).to(dtype)
        s = torch.arange(W, device=cuda)
        last = pos - torch.remainder(pos - s, W)  # ring slots, -1 unwritten
        slot = torch.where(last >= 0, last, -1).to(torch.int32)
        got = kfd.flash_decode(q, k, v, slot, pos, window=window)
        want = kfd.flash_decode_plain(q, k, v, slot, pos, window=window)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert kfd.counts() == {"flash_decode": {"launches": 3,
                                             "plain_calls": 0}}


@pytest.mark.cuda
def test_cuda_generate_reduced_matches_teacher_forcing(cuda):
    """qwen2-reduced through the serve loop on the card: K10 once per layer
    per step, each step's logits within 2e-4 of teacher forcing (the
    reference's own decode tolerance)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    model = build_model(cfg, device=cuda)
    params = model.init(prf.PRNGKey(0))
    tokens = prf.randint(prf.PRNGKey(1), (2, 16), 0, cfg.vocab_size,
                         device=cuda).long()
    kfd.reset_counts()
    gen = serve.generate(model, params, tokens, 4, keep_logits=True)
    assert kfd.counts()["flash_decode"] == {
        "launches": cfg.num_layers * 4, "plain_calls": 0}
    full = torch.cat([tokens, gen.tokens[:, :4]], dim=1)
    logits, _ = model.apply(params, {"tokens": full})
    for i, step in enumerate(gen.logits):
        torch.testing.assert_close(step, logits[:, 15 + i], rtol=0,
                                   atol=2e-4)


@pytest.mark.cuda
def test_cuda_round_kernels_match_plain_versions(cuda):
    """K6 and K7 bit-equal (edge inputs, both multipliers), K3 within rtol
    1e-5 and K8 within 1e-6 of the largest |s x| sum (f32 sums)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    ksa.reset_counts()
    kdp.reset_counts()
    for D in (1, 1000, 100_003, 100_004):
        x = torch.randn(D, generator=g, device=cuda) * 3.0
        x[0] = math.inf if D > 1 else math.nan
        u = torch.rand(D, generator=g, device=cuda)
        m = torch.randint(-2 ** 31, 2 ** 31, (D,), generator=g, device=cuda,
                          dtype=torch.int64).to(torch.int32)
        for mask in (m, None):
            assert torch.equal(
                ksa.quantize_mask(x, mask, u, 131067.5, math.inf),
                ksa.quantize_mask_plain(x, mask, u, 131067.5, math.inf))
        for inv in (ksa.pallas_inverse(33554430.75),
                    ksa.jit_inverse(33554430.75)):
            assert torch.equal(ksa.dequantize(m, inv),
                               ksa.dequantize_plain(m, inv))
        xs = torch.randn(3, D, generator=g, device=cuda)
        s = torch.rand(3, generator=g, device=cuda)
        torch.testing.assert_close(kdp.sq_norms(xs), kdp.sq_norms_plain(xs),
                                   rtol=1e-5, atol=0)
        top = float((s[:, None] * xs).abs().sum(0).max())
        assert float((kdp.scale_accum(xs, s)
                      - kdp.scale_accum_plain(xs, s)).abs().max()) \
            <= 1e-6 * top
    assert ksa.quantize_mask.launches == 8 and ksa.dequantize.launches == 8
    assert kdp.sq_norms.launches == 4 and kdp.scale_accum.launches == 4
    assert ksa.quantize_mask.plain_calls == kdp.sq_norms.plain_calls == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [32, 0])
def test_cuda_round_matches_the_cpu_round(cuda, bits):
    """A qwen2-reduced round on the card (kernels) against the same round on
    the CPU (plain versions): local SGD and f32 sums differ in the last
    bits, so the params agree to 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get_config("qwen2-1.5b", reduced=True)
    model = build_model(cfg, device="cpu")
    params = model.init(prf.PRNGKey(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 1, 16),
                                     generator=g)}
    fl = FLConfig(cohort_size=4, local_lr=0.2, noise_multiplier=0.0,
                  secure_agg_bits=bits, secure_agg_masked=bits > 0)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = T.tree_map(lambda x: x.to(dev), params)
        step = fl_round.build_round_step(model.loss_fn, fl, cohort_size=4,
                                         clients_per_chunk=2, device=dev)
        ksa.reset_counts()
        kdp.reset_counts()
        new, _ = step(fl_round.init_fl_state(p, fl), dict(batch), (3, 4))
        outs[dev] = new.params
    assert kdp.sq_norms.launches == 2 * len(T.leaves(params))
    assert ksa.quantize_mask.plain_calls == kdp.sq_norms.plain_calls == 0
    for a, b in zip(T.leaves(outs["cpu"]), T.leaves(outs["cuda"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.0, 0.1, 1.0])
def test_cuda_bit_counts_and_threshold_cdf_match_the_cpu(cuda, p):
    """K9 bit-equal to its plain version (ragged N and F, boundary
    uniforms, NaN values, +-inf thresholds); the fused CDF vote on the card
    bit-equal to the same vote on the CPU (the same draws; at p = 1 the
    debias divides by 1 - p = 0, so NaN where the reference has NaN)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    k9.reset_counts()
    for N, F, T in ((1, 1, 1), (999, 7, 64), (4097, 3, 129)):
        v = torch.randn(N, F, generator=g, device=cuda)
        v[0, 0] = math.nan
        thr = torch.sort(torch.randn(T, generator=g, device=cuda)).values
        thr[0] = -math.inf
        u = torch.rand(N, F, T, generator=g, device=cuda)
        u.view(-1)[:2] = torch.tensor([p / 2.0, p])[:u.numel()]
        assert torch.equal(k9.bit_counts(v, thr, u, p),
                           k9.bit_counts_plain(v, thr, u, p))
    assert k9.bit_counts.launches == 3 and k9.bit_counts.plain_calls == 0
    v = torch.randn(3000, 5, generator=g, device=cuda) * 2.0
    thr = fa.linspace(-3.0, 3.0, 33, device=cuda)
    got = fa.threshold_cdf(v, thr, (1, 2), p)
    want = fa.threshold_cdf(v.cpu(), thr.cpu(), (1, 2), p)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,two_level,bits", [
    ("client", True, 16), ("tee_stream", False, 32), ("tee", True, 32)])
def test_cuda_tier_matches_the_cpu_tier(cuda, mode, two_level, bits):
    """The 4 x 2 tier on the card (K1 / K2's PRF lane / K5 per leaf) lands
    the CPU tier's buffers and params bit for bit, through a full session
    and a flush that recovers a dropped client and a dead leaf."""
    from repro_torch.core.fl.hierarchy import ShardedAsyncServer
    fl = FLConfig(clip_norm=1.0, secure_agg_bits=bits,
                  param_chunk_elems=600)
    g = torch.Generator().manual_seed(5)
    params = {"a": torch.zeros(700), "b": torch.zeros(3, 40)}
    deltas = [{k: torch.randn(v.shape, generator=g) * 0.01
               for k, v in params.items()} for _ in range(14)]
    out = []
    for dev in ("cpu", cuda):
        srv = ShardedAsyncServer(params, fl, num_leaves=4, leaf_buffer=2,
                                 mask_mode=mode, two_level=two_level,
                                 staleness_mode="constant", device=dev)
        stack = {k: torch.stack([d[k] for d in deltas[:8]]) for k in params}
        if mode == "client":
            srv.push_encoded(srv.encode_push(stack, 0))
        else:
            srv.push(stack, 0)
        for s, d in zip((0, 2, 3, 5), deltas[8:]):
            if s == 5:
                srv.mark_leaf_dead(1)  # loses slots 2 and 3
            if mode == "client":
                srv.push_encoded(srv.encode_push(d, 1, slot=s))
            else:
                srv.push(d, 1, slots=s)
        assert srv.flush()
        out.append((srv.params, [b.cpu() for b in srv._bufs]))
    (pc, bc), (pg, bg) = out
    assert all(torch.equal(a, b.cpu()) for a, b in zip(T.leaves(pc),
                                                       T.leaves(pg)))
    assert all(torch.equal(a, b) for a, b in zip(bc, bg))


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 4])
def test_cuda_encode_masked_contribution_through_k1(cuda, degree):
    """``encode_masked_contribution`` launches K1 on the card; its rows
    equal the plain branch (``_stream_quantize`` + ``session.mask``) on the
    card and the CPU's, and a flush with two dropped slots recovers the
    survivors' unmasked aggregate bit for bit."""
    from repro_torch.core.fl import aggregation as agg
    spec = agg.make_spec(FLConfig(clip_norm=1.0, secure_agg_bits=32,
                                  secure_agg_degree=degree,
                                  noise_multiplier=0.0), 8)
    sess = agg.make_mask_session(spec, prf.PRNGKey(77))
    g = torch.Generator().manual_seed(degree)
    xs = [torch.randn(100_003, generator=g) * 1e-3 for _ in range(8)]
    rows, plain = [], []
    ksa.reset_counts()
    for b, x in enumerate(xs):
        rng = prf.fold_in(prf.PRNGKey(88), b)
        row = agg.encode_masked_contribution(x.to(cuda), 1.0, b, spec, sess,
                                             rng)[0]
        alt = agg.encode_masked_contribution(x.to(cuda), 1.0, b, spec, sess,
                                             rng, use_kernel=False)[0]
        cpu = agg.encode_masked_contribution(x, 1.0, b, spec, sess, rng)[0]
        assert torch.equal(row, alt) and torch.equal(row.cpu(), cpu)
        rows.append(row)
        plain.append(agg.encode_contribution(x.to(cuda), 1.0, spec, rng)[0])
    assert ksa.quantize_mask_prf.launches == 8
    present = [1, 1, 0, 1, 1, 0, 1, 1]
    got = agg.aggregate_masked_buffer(torch.stack(rows), present, 6.0, spec,
                                      sess, (0, 9))
    want = agg.aggregate_masked_buffer(torch.stack(plain), present, 6.0,
                                       spec, None, (0, 9), masked=False)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m",
                                  "recurrentgemma-2b", "internvl2-76b",
                                  "whisper-tiny"])
def test_cuda_family_round_matches_the_cpu_round(cuda, arch):
    """One reduced round of each non-dense family through ``train.main`` on
    the card against the CPU's: the printed loss and norms within 1e-4, the
    params within 1e-5 (autograd and f32 sums in other orders; a MoE
    top-k near-tie could route a token apart, none does at this seed)."""
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ["--arch", arch, "--rounds", "1", "--cohort", "4", "--seq-len",
            "16", "--noise", "0"]
    out = {}
    for dev in ("cpu", "cuda"):
        session = {}
        kdp.reset_counts()
        assert train.main(argv + ["--device", dev], session=session) == 0
        out[dev] = session
    assert kdp.sq_norms.plain_calls == 0 and kdp.sq_norms.launches > 0
    for k in ("loss", "update_norm", "clip_fraction"):
        assert out["cuda"]["metrics"][0][k] == pytest.approx(
            out["cpu"]["metrics"][0][k], abs=1e-4)
    for a, b in zip(T.leaves(out["cpu"]["state"].params),
                    T.leaves(out["cuda"]["state"].params)):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_gloo_world_of_two_matches_the_one_process_tier(cuda):
    """Two gloo ranks sharing the card (each holds 2 of the 4 leaves,
    gloo stages the combine through the host) end every run with
    the one-process tier's params, bit for bit: a full session, then a
    recovering flush after two dropouts and a dead leaf."""
    import numpy as np

    from repro_torch.launch import dist
    from repro_torch.testing import (NumpySource, TierCase, run_tier_case,
                                     tier_world)
    rs = np.random.RandomState(5)
    src = NumpySource({"a": np.zeros(700, np.float32),
                       "b": np.zeros((3, 40), np.float32)},
                      [{"a": (rs.randn(700) * 0.01).astype(np.float32),
                        "b": (rs.randn(3, 40) * 0.01).astype(np.float32)}
                       for _ in range(13)])
    steps = (("push", tuple(range(8)), 0, tuple(range(8))),
             ("push", (8, 9, 10), 1, (0, 4, 5)), ("dead", 2),
             ("push", (11, 12), 1, (3, 7)), ("flush", 17))
    fl = dict(clip_norm=1.0, param_chunk_elems=600)
    cases = [TierCase("client-tree-16", "client", True, 4, 2,
                      dict(fl, secure_agg_bits=16), steps),
             TierCase("tee_stream-flat", "tee_stream", False, 4, 2,
                      dict(fl, secure_agg_bits=32), steps),
             TierCase("tee-flat", "tee", False, 4, 2,
                      dict(fl, secure_agg_bits=32), steps)]
    ranks = dist.run(tier_world, 2, [src], cases, device="cuda",
                     backend="gloo")
    for case in cases:
        one = run_tier_case(case, src.build(cuda), device=cuda)
        for r in ranks:
            got = r[case.name]["params"]
            assert all(torch.equal(a, b.cpu()) for a, b in zip(
                T.leaves(got), T.leaves(one.params))), case.name
