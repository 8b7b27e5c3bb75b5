"""The signed sum of pair streams (``kernels/prf.py`` ``signed_pair_sum``)
in its accumulate form, on the CPU.

- Added into a row in place (``out=``), it equals today's fresh sum padded
  and added word by word, ``to_int32(words_of(acc) + words_of(pad(rec)))``,
  bit for bit, and leaves the row's tail as it was
  (``testing.PAIR_SUM_CASES``, shared with the card's tests);
- a streamed flush that recovers one or two absent slots decodes the mean
  of that padded add, and the CPU still runs the host tile loop
  (``prf_host_tiles``);
- an abstract tensor records D3's cost and launches nothing; a row the sum
  cannot add into raises; the plain versions never reach the dispatcher.
"""
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs.base import FLConfig
from repro_torch.core import telemetry as tele
from repro_torch.core.fl import aggregation as agg
from repro_torch.core.fl import secure_agg as sa
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa
from repro_torch.launch import analysis
from repro_torch.testing import PAIR_SUM_CASES, pair_sum_case, pin_cpu_threads

pin_cpu_threads()


@pytest.fixture
def registry():
    """A fresh process registry, the previous one restored after."""
    tel = tele.Telemetry(record_spans=False)
    prev = tele.set_default(tel)
    try:
        yield tel
    finally:
        tele.set_default(prev)


def padded_add(row: torch.Tensor, rec: torch.Tensor) -> torch.Tensor:
    """The recovery add before the accumulate form: the fresh sum padded to
    the row's width and added in int64 words."""
    rec = torch.nn.functional.pad(rec, (0, row.numel() - rec.numel()))
    return prf.to_int32(prf.words_of(row) + prf.words_of(rec))


@pytest.mark.parametrize("name", PAIR_SUM_CASES)
def test_accumulate_form_equals_the_padded_add(monkeypatch, registry, name):
    key, lo, hi, gains, length, row = pair_sum_case(name)
    monkeypatch.setattr(prf, "TILE", 1 << 12)  # several tiles a sum
    want = padded_add(row, prf.signed_pair_sum(*key, lo, hi, gains, length))
    tiles = registry.total("prf_host_tiles")
    got = prf.signed_pair_sum(*key, lo, hi, gains, length, out=row)
    assert got is row
    assert torch.equal(row, want)
    live = any(g != 0 for g in gains) and length > 0
    assert (registry.total("prf_host_tiles") > tiles) == live
    assert registry.total("prf_device_pairs") == 0


@pytest.mark.parametrize("degree", [0, 4])
def test_recovery_into_a_chunk_sum_equals_the_padded_add(degree):
    """``MaskSession.recovery(..., out=)`` and ``recovery_sweep(..., w,
    out=)``, the engine's and the tier's forms."""
    sess = sa.make_session((9, 10), 12, degree=degree)
    present = [1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1]
    g = torch.Generator().manual_seed(degree)
    row = torch.randint(-2 ** 31, 2 ** 31, (1000,), generator=g,
                        dtype=torch.int32)
    want = padded_add(row, sess.recovery((997,), present))
    assert sess.recovery((997,), present, out=row) is row
    assert torch.equal(row, want)
    lo, hi = sess.edges()
    w = [(i + 1) % 3 for i in range(len(lo))]
    want = padded_add(row, sa.recovery_sweep((997,), present, lo, hi,
                                             sess.key, w))
    sa.recovery_sweep((997,), present, lo, hi, sess.key, w, out=row)
    assert torch.equal(row, want)
    want = padded_add(row, sess.mask((997,), 4))
    sess.mask((997,), 4, out=row)
    assert torch.equal(row, want)


@pytest.mark.parametrize("absent", [(3,), (0, 2)])
def test_plan_recovery_decodes_the_mean_of_the_padded_add(registry, absent):
    """A streamed flush with one and with two absent slots of four: the
    chunk sums take the sweeps in place; the mean is the one decoded from
    the padded adds, and the CPU runs the tile loop."""
    B = 4
    fl = FLConfig(clip_norm=1.0, server_lr=1.0, secure_agg_bits=32,
                  param_chunk_elems=2048)
    plan = agg.plan_for({"w": torch.zeros(3000), "b": torch.zeros(700)}, fl)
    spec = agg.make_spec(fl, B)
    sessions = agg.plan_sessions(spec, plan, prf.PRNGKey(7))
    wire = agg.plan_wire_chunks(spec, plan)
    assert any(wc.padded > wc.size for wc in wire)
    g = torch.Generator().manual_seed(len(absent))
    bufs = [torch.randint(-2 ** 20, 2 ** 20, (B, wc.padded), generator=g,
                          dtype=torch.int32) for wc in wire]
    present = [int(b not in absent) for b in range(B)]
    w_total = torch.tensor(float(B - len(absent)))
    rng = prf.PRNGKey(11)
    got = agg.aggregate_plan_masked_buffer(bufs, present, w_total, spec,
                                           plan, sessions, rng)
    assert registry.total("prf_host_tiles") > 0
    gate = [p == 1 for p in present]
    accs = [padded_add(agg.sum_rows(buf, gate),
                       sessions[c].recovery((wc.size,), present))
            for c, (wc, buf) in enumerate(zip(wire, bufs))]
    want = agg.finalize_plan_aggregate(accs, w_total, spec, plan,
                                       prf.fold_in(rng, 0xDEE))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(got),
                                                 T.leaves(want)))


@pytest.mark.parametrize("accumulate", [False, True])
def test_pair_sum_on_abstract_tensors_records_the_kernel(registry,
                                                         accumulate):
    key, lo, hi, gains, length, _ = pair_sum_case("many-pairs")
    pairs = sum(1 for x in gains if x != 0)
    row = torch.empty((length + 5,), dtype=torch.int32, device="meta")
    with analysis.CostMode() as cm:
        got = prf.signed_pair_sum(*key, lo, hi, gains, length, device="meta",
                                  out=row if accumulate else None)
    assert got.is_meta
    assert got is row if accumulate else got.shape == (length,)
    rec = cm.counts.kernels["pair_sum"]
    assert rec["calls"] == 1
    assert rec["int_ops"] == \
        analysis.THREEFRY_OPS * pairs * ((length + 1) // 2)
    assert rec["bytes"] == 4 * length * (2 if accumulate else 1)
    assert registry.total("prf_host_tiles") == 0
    assert registry.total("prf_device_pairs") == 0


@pytest.mark.parametrize("row", [
    torch.zeros((64,), dtype=torch.int64),
    torch.zeros((128,), dtype=torch.int32)[::2],
    torch.zeros((63,), dtype=torch.int32)], ids=["int64", "strided", "short"])
def test_pair_sum_refuses_a_row_it_cannot_add_into(row):
    with pytest.raises(ValueError, match="contiguous int32 row"):
        prf.signed_pair_sum(1, 2, [0], [1], [1], 64, out=row)


def test_plain_versions_keep_the_tile_loop(monkeypatch):
    """``session_mask_plain`` (K1's and K2's plain versions) runs
    ``signed_pair_sum_plain``, never the dispatcher that launches D3."""
    session = ksa.SessionMeta(key_words=(3, 4), num_slots=6, degree=0,
                              slot_offset=0, neighbors=None)
    want = ksa.session_mask_plain(2, 301, session)

    def dispatcher(*a, **kw):
        raise AssertionError("a plain version reached signed_pair_sum")
    monkeypatch.setattr(prf, "signed_pair_sum", dispatcher)
    assert torch.equal(ksa.session_mask_plain(2, 301, session), want)
