"""The work counts of ``bench/work`` against figures worked out by hand."""
import json

import pytest

from bench import harness as H
from bench.work import counts


def test_peaks_are_the_published_figures():
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert counts.PEAKS["f32_flops_per_s"] == 67e12
    # 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
    assert counts.PEAKS["int32_ops_per_s"] == pytest.approx(
        132 * 128 * 1.98e9, rel=1e-4)
    assert counts.PEAKS["threefry_ops_per_round"] == 3


def test_parameter_counts_by_hand():
    mamba = H.load_json(H.BENCH / "configs" / "mamba2-780m.json")
    # embed 50280*1536 + final norm 1536 + 48 x (in_proj 1536*6448,
    # conv 4*3328 + 3328, out_proj 3072*1536, A_log/D/dt_bias 3*48,
    # gated norm 3072, norm1 1536)
    layer = (1536 * 6448 + 5 * 3328 + 3072 * 1536 + 3 * 48 + 3072 + 1536)
    assert counts.param_leaves(mamba) == (
        50280 * 1536 + 1536 + 48 * layer, 11)
    whisper = H.load_json(H.BENCH / "configs" / "whisper-tiny.json")
    attn, mlp, ln = 4 * 384 * 384, 2 * 384 * 1536, 2 * 384
    n = 51865 * 384 + 64 * 384 + 4 * (attn + mlp + 2 * ln) + ln \
        + 4 * (2 * attn + mlp + 3 * ln) + ln
    assert counts.param_leaves(whisper) == (n, 110) == (36472704, 110)


def test_push_and_flush_by_hand():
    # 1000 elements, 10 slots: a uniform word and 9 mask words an element,
    # two words an evaluation, 13 rounds of 3 operations
    w = counts.push_work(1000, 10)
    assert w == {"bytes": 8000.0, "flops": 5000.0,
                 "int_ops": 1000 * 10 / 2 * 39}
    # 9 present of 10: one absent slot, 9 edges regenerated
    f = counts.flush_work(1000, 10, 9)
    assert f == {"bytes": 4000.0 * 9 + 8000.0, "flops": 3000.0,
                 "int_ops": 1000 * 9 / 2 * 39}
    assert counts.flush_work(1000, 10, 10)["int_ops"] == 0
    v = counts.version_work(1000, 10, 9)
    assert v["int_ops"] == 9 * 195000 + 175500


def test_least_time_takes_the_largest_term():
    t = counts.least_time({"bytes": 3.35e12, "flops": 6.7e12,
                           "int_ops": 3.3454e12})
    assert t == pytest.approx(1.0)
    assert counts.least_time({"int_ops": 3.3454e13}) == pytest.approx(1.0)


def test_encdec_flops_by_hand():
    m = {"d_model": 4, "num_heads": 2, "num_kv_heads": 2, "head_dim": 2,
         "d_ff": 8, "vocab_size": 10, "num_encoder_layers": 1,
         "num_layers": 1}
    # encoder, 3 frames: projections 2*4*(2*4 + 2*4) = 128 a frame, scores
    # and mixing 4*3*4 = 48, MLP 4*4*8 = 128 -> 3 * 304 = 912
    enc = 3 * (128 + 48 + 128)
    # decoder, 2 tokens: self 2 * (128 + 4*2*4) = 320; cross q/o 2*4*4*4 =
    # 128, memory k/v 3*4*4*4 = 192, scores 2*4*3*4 = 96; MLP 2*128 = 256;
    # logits 2*2*4*10 = 160
    dec = 320 + 128 + 192 + 96 + 256
    assert counts.encdec_forward_flops(m, 3, 2) == enc + dec + 160


def test_round_by_hand():
    m = {"d_model": 4, "num_heads": 2, "num_kv_heads": 2, "head_dim": 2,
         "d_ff": 8, "vocab_size": 10, "num_encoder_layers": 1,
         "num_layers": 1}
    f = counts.encdec_forward_flops(m, 3, 2)
    w = counts.round_work(m, 100, 4, 3, 2, 1, True)
    assert w == {"flops": 3.0 * 4 * f, "bytes": 8.0 * 100 * 6,
                 "int_ops": (4 * 100 + 100) * 60}


def test_peaks_file_names_its_sources():
    peaks = json.loads((H.BENCH / "work" / "peaks.json").read_text())
    for k, v in peaks.items():
        if isinstance(v, dict):
            assert v["source"] and v["value"] > 0, k
