"""The traffic generator: deterministic per seed, the stated lengths and
sharing."""
import json

import numpy as np

from portbench.lib.spec import HERE
from portbench.lib.traffic import (Traffic, lognormal_points, rng,
                                   seed_words, torch_seed)

SPEC = json.loads((HERE / "traffic" / "shared_prefix.json").read_text())


def test_same_seed_same_batches_other_seed_other_tokens():
    a, b = Traffic(SPEC, 2 ** 33 + 7, 64000), Traffic(SPEC, 2 ** 33 + 7, 64000)
    c = Traffic(SPEC, 2 ** 33 + 8, 64000)
    for i in (0, 1, 17):
        for x, y in zip(a.batch(i), b.batch(i)):
            assert np.array_equal(x, y)
        assert not np.array_equal(a.batch(i)[0][:, -16:],
                                  c.batch(i)[0][:, -16:])
    assert np.array_equal(a.docs, b.docs)


def test_lengths_and_ids():
    t = Traffic(SPEC, 5, 64000)
    # median 1500, sigma 0.5 at 1/6, 1/2, 5/6; whole 16-token chunks
    assert t.prompt_lens == [928, 1504, 2432]
    assert t.doc_lens == [688, 1120, 1824]
    assert np.allclose(lognormal_points(1500, 0.5, 3)[1], 1500)
    assert sorted(t.answers.tolist()) == [5, 7, 8, 9, 10, 11, 12, 13, 14,
                                          15, 16, 17, 19, 22, 25, 33]
    assert t.decode_tokens == 33 and t.max_seq == 2432 + 33
    assert t.docs.shape == (24, 1824)


def test_every_cycle_sends_every_length_once_every_batch_every_answer():
    t = Traffic(SPEC, 2 ** 31 + 9, 64000)
    orders = set()
    for cycle in range(6):
        lens = [t.batch(3 * cycle + k)[0].shape[1] for k in range(3)]
        assert sorted(lens) == t.prompt_lens
        orders.add(tuple(lens))
    assert len(orders) > 1                       # the order is drawn
    for i in range(6):
        x, answers = t.batch(i)
        assert x.shape[0] == 16 and x.dtype == np.int32
        assert x.min() >= 1 and x.max() < 64000
        assert sorted(answers.tolist()) == sorted(t.answers.tolist())


def test_every_prompt_is_a_pool_document_then_a_fresh_question():
    t = Traffic(SPEC, 9, 64000)
    questions = set()
    for i in range(12):
        x, _ = t.batch(i)
        d = t.doc_lens[t.prompt_lens.index(x.shape[1])]
        for row in x:
            assert (t.docs[:, :d] == row[:d]).all(axis=1).any()
            questions.add(row[d:].tobytes())
    assert len(questions) == 12 * 16


def test_documents_follow_zipf_over_the_pool():
    t = Traffic(SPEC, 11, 64000)
    counts = np.zeros(24)
    for i in range(300):
        x, _ = t.batch(i)
        for row in x[:, :600]:
            counts[np.nonzero((t.docs[:, :600] == row).all(axis=1))[0][0]] += 1
    share = counts / counts.sum()
    want = np.arange(1, 25) ** -0.8
    want /= want.sum()
    assert np.abs(share - want).max() < 0.02


def test_warm_batches_cover_every_length():
    t = Traffic(SPEC, 4, 64000)
    warm = t.warm_batches()
    assert [w[0].shape[1] for w in warm] == [928, 1504, 2432, 2432]
    # drawn from a stream the window never uses
    assert not any(np.array_equal(w[0][:, -16:], t.batch(i)[0][:, -16:])
                   for w in warm for i in range(6)
                   if t.batch(i)[0].shape == w[0].shape)


def test_fill_and_sample():
    t = Traffic(SPEC, 3, 64000)
    fill = t.fill_batches()
    assert len(fill) == 2 and [f.shape for f in fill] == [(16, 1824),
                                                          (8, 1824)]
    assert np.array_equal(np.concatenate(fill), t.docs)
    lens = np.repeat([1504, 928, 2432, 1504, 2432], 16)
    s = t.sample(lens)
    assert len(s) == 16 and len(set(s.tolist())) == 16 and s.max() < 80
    # dealt over the lengths, the longest first: 6, 5 and 5
    assert [int((lens[s] == n).sum()) for n in (2432, 1504, 928)] == [6, 5, 5]
    assert np.array_equal(s, Traffic(SPEC, 3, 64000).sample(lens))
    assert len(t.sample(lens[:5])) == 5


def test_any_whole_seed():
    for seed in (0, 1, -1, 2 ** 31 + 5, 2 ** 40, -(2 ** 70)):
        assert all(0 <= w < 2 ** 32 for w in seed_words(seed))
        assert 0 <= torch_seed(seed) < 2 ** 63
    assert seed_words(1) != seed_words(-1)
    assert rng(2 ** 31 + 5, 1).integers(10 ** 9) == \
        rng(2 ** 31 + 5, 1).integers(10 ** 9)


def test_empty_documents_make_unique_prompts():
    spec = dict(SPEC, doc_share=0, doc_pool=0)
    t = Traffic(spec, 1, 1000)
    x, _ = t.batch(0)
    assert x.shape[0] == 16 and t.fill_batches() == []
