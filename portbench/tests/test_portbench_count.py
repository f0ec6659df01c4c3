"""The frozen FLOP and byte counters against hand counts."""
import numpy as np
import pytest

from portbench.count import bytes as nbytes, flops

DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "d_head": 4, "d_ff": 16, "vocab_size": 10,
         "mlp_gated": True}
HYBRID = {"family": "hybrid", "n_layers": 6, "d_model": 8, "n_heads": 2,
          "n_kv_heads": 2, "d_head": 8, "d_ff": 16, "vocab_size": 10,
          "mlp_gated": True, "ssm_state": 4, "ssm_expand": 2, "ssm_conv": 4,
          "ssm_head_dim": 4, "shared_attn_every": 3}


def test_dense_by_hand():
    # a layer: wq 8x8 + wk, wv 8x4 + wo 8x8 + 3 x 8x16 = 64+64+64+384
    assert flops.layer_macs(DENSE, flops.ATTN) == 576
    # positions 0, 1, 2: 3 tokens x 2 layers x 2 x 576, attention
    # 4 x 2 heads x 4 x (1 + 2 + 3) a layer
    want = 3 * 2 * 2 * 576 + 2 * 4 * 2 * 4 * 6
    assert flops.tokens_flops(DENSE, [0, 1, 2]) == want
    assert flops.logits_flops(DENSE, 3) == 2 * 8 * 10 * 3


def test_hybrid_by_hand():
    kinds = flops.layer_kinds(HYBRID)
    assert kinds == ["mamba2", "mamba2", "shared_attn"] * 2
    # wz 8x16, wxbc 8x24, wdt 8x4 (16 / 4 heads), out 16x8
    assert flops.layer_macs(HYBRID, flops.MAMBA2) == 128 + 192 + 32 + 128
    scan = 5 * 16 * 4 + 2 * 4 * 24
    # attention 2 heads of 8 (16 wide) over an 8-wide input: wq, wk, wv
    # 8x16, wo 16x8, MLP 3 x 8x16
    shared = 8 * 16 + 2 * 8 * 16 + 16 * 8 + 3 * 8 * 16
    want = 4 * (2 * 480 + scan) + 2 * (2 * shared + 4 * 2 * 8 * 1)
    assert flops.tokens_flops(HYBRID, [0]) == want


def test_restored_tokens_are_not_counted():
    full, dec = flops.batch_flops(DENSE, 8, 0, [3, 3])
    resumed, dec2 = flops.batch_flops(DENSE, 8, 4, [3, 3])
    assert dec == dec2
    assert full - resumed == pytest.approx(2 * flops.tokens_flops(
        DENSE, np.arange(4)))
    # 2 decode steps at positions 8 and 9, each with its logits
    assert dec == pytest.approx(2 * (flops.tokens_flops(DENSE, [8])
                                     + flops.tokens_flops(DENSE, [9]))
                                + 2 * flops.logits_flops(DENSE, 2))
    # a row of 1 token needs no step, one of 3 needs two
    _, short = flops.batch_flops(DENSE, 8, 0, [1, 3])
    assert short == pytest.approx(dec / 2)


def test_other_families_have_no_count():
    with pytest.raises(ValueError):
        flops.layer_kinds(dict(DENSE, family="ssm"))


def test_search_bytes_by_hand():
    geo = {"key_bits": 32, "set_ways": 512, "plane_format": "int8"}
    assert nbytes.plane_bytes_per_set(geo) == 32 * 512 + 512
    assert nbytes.multiset_search_bytes(geo, 2048, 8) == \
        8 * 16896 + 2048 * 8
    packed = dict(geo, plane_format="packed8")
    assert nbytes.plane_bytes_per_set(packed) == 4 * 512 + 512
