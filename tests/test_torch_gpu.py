"""Card-only tests of the port (marker ``gpu``): they skip without a CUDA
device and import neither JAX nor the reference package, so they run on
the card's machine as they are:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.common import pack_bits_np
from repro_torch.kernels.xam_search import ops
from repro_torch.kernels.xam_search.ref import xam_search_multiset_plain


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _operands(rng, n_sets, r, c, n_q, packed):
    planes = rng.integers(0, 2, (n_sets, r, c)).astype(np.int8)
    valid = rng.integers(0, 2, (n_sets, c)).astype(np.int8)
    sets = rng.integers(0, n_sets, n_q)
    bits = rng.integers(0, 2, (n_q, r)).astype(np.int8)
    planes[sets[::3], :, 11] = bits[::3]
    valid[sets[::3], 11] = 1
    block_q = ops._pick_block_q(n_q, None)
    keys, masks, bs, live, _ = ops.pack_multiset_batch(bits, sets, n_sets,
                                                       block_q)
    if packed:
        planes = pack_bits_np(planes, axis=1)
    return [torch.from_numpy(x).cuda() for x in (keys, masks, planes, valid,
                                                 bs, live)], block_q


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_sets,r,c,n_q", [(8, 32, 512, 96), (6, 24, 96, 100),
                                            (32, 32, 512, 300)])
def test_cuda_kernel_matches_plain_on_card(n_sets, r, c, n_q, packed):
    _needs_card()
    operands, bq = _operands(np.random.default_rng(0), n_sets, r, c, n_q,
                             packed)
    before = ops.LAUNCH_COUNT
    got = ops.xam_search_multiset_device(*operands, block_q=bq)
    torch.cuda.synchronize()
    assert got.is_cuda and ops.LAUNCH_COUNT == before + 1
    assert torch.equal(got, xam_search_multiset_plain(*operands, block_q=bq))
    assert bool((got >= 0).any())


@pytest.mark.gpu
def test_card_lookup_equals_cpu_lookup():
    _needs_card()
    rng = np.random.default_rng(1)
    from repro_torch.serve.kv_index import KVIndexConfig, MonarchKVIndex
    toks = rng.integers(1, 500, (3, 64)).astype(np.int32)
    cfg = dict(n_sets=8, set_ways=16, admit_after_reads=0)
    gpu = MonarchKVIndex(KVIndexConfig(**cfg))
    cpu = MonarchKVIndex(KVIndexConfig(**cfg), device="cpu")
    for idx in (gpu, cpu):
        idx.admit(toks[:2])
    np.testing.assert_array_equal(gpu.lookup(toks), cpu.lookup(toks))
    assert gpu.bits.is_cuda
    assert torch.equal(gpu.bits.cpu(), cpu.bits)
