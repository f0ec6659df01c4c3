"""Operations a model needs, counted from its configuration alone: a
frozen yardstick that no change to the program moves.

Two operations a multiply-add.  A computed token costs every product
with a weight once (each call of a tied block counts: zamba2's shared
block at each of its calls), its causal attention over its context (a
query at position p reads p + 1 keys; 2 for the scores and 2 for the
values a key and head dimension), and a Mamba-2 layer's scan (5 a state
element, the recurrence's update and read-out) and causal convolution.
A row's logits cost one unembedding product.  Tokens restored from a
cache are not computed, so they are not counted.  Two families are
counted, those of the benchmark's cells: ``dense`` (attention layers)
and ``hybrid`` (Mamba-2 layers with a shared attention block every
``shared_attn_every``-th); a cell of another family brings its count.
"""
from __future__ import annotations

import numpy as np

ATTN, SHARED, MAMBA2 = "attn", "shared_attn", "mamba2"


def layer_kinds(model: dict) -> list[str]:
    """Each layer's kind, in stack order."""
    n = model["n_layers"]
    if model["family"] == "dense":
        return [ATTN] * n
    if model["family"] == "hybrid":
        e = model["shared_attn_every"]
        return [SHARED if (i + 1) % e == 0 else MAMBA2 for i in range(n)]
    raise ValueError(f"no count for the family {model['family']!r}")


def layer_macs(model: dict, kind: str) -> int:
    """Multiply-adds with weights, one token, one layer of ``kind``."""
    m = model
    d = m["d_model"]
    if kind in (ATTN, SHARED):
        h, kv = m["n_heads"] * m["d_head"], m["n_kv_heads"] * m["d_head"]
        ffn = (3 if m["mlp_gated"] else 2) * d * m["d_ff"]
        return d * h + 2 * d * kv + h * d + ffn
    di, n = m["ssm_expand"] * d, m["ssm_state"]
    return d * di + d * (di + 2 * n) + d * (di // m["ssm_head_dim"]) \
        + di * d


def _scan_flops(m: dict, kind: str) -> int:
    if kind != MAMBA2:
        return 0
    di, n, k = m["ssm_expand"] * m["d_model"], m["ssm_state"], m["ssm_conv"]
    return 5 * di * n + 2 * k * (di + 2 * n)


def tokens_flops(model: dict, positions) -> float:
    """Operations to compute one row's tokens at ``positions`` (absolute,
    each attending to every earlier position of its row)."""
    pos = np.asarray(positions, np.float64)
    total = 0.0
    for kind in layer_kinds(model):
        total += pos.size * (2.0 * layer_macs(model, kind)
                             + _scan_flops(model, kind))
        if kind != MAMBA2:
            total += 4.0 * model["n_heads"] * model["d_head"] * float(
                (pos + 1).sum())
    return total


def logits_flops(model: dict, rows: int) -> float:
    """Operations of ``rows`` rows of logits."""
    return 2.0 * model["d_model"] * model["vocab_size"] * rows


def batch_flops(model: dict, prompt_len: int, restored: int,
                answers) -> tuple[float, float]:
    """(prefill, decode) operations one served batch needs: a row a
    request, each a prompt of ``prompt_len`` of which ``restored``
    leading tokens came from the cache, then its answer of ``answers[r]``
    greedy tokens (the first from the prefill's logits, each later one a
    decode step at the next position)."""
    answers = np.asarray(answers)
    rows = answers.size
    prefill = rows * tokens_flops(model, np.arange(restored, prompt_len)) \
        + logits_flops(model, rows)
    decode = 0.0
    for t in range(int(answers.max()) - 1):
        need = int((answers - 1 > t).sum())     # rows still answering
        decode += need * (tokens_flops(model, [prompt_len + t])
                          + logits_flops(model, 1))
    return prefill, decode
