"""Plain float32 reference of a dense grouped-query-attention decoder
(Yi-9B, arXiv:2403.04652: LLaMA's block).

Each layer is ``x + attn(norm(x))`` then ``+ mlp(norm(x))``: RMS norm
scaled by ``1 + w``, rotary embedding over the halves of each head,
causal softmax attention in which query head h reads KV head
``h // (n_heads / n_kv_heads)``, and the SwiGLU MLP; the embedding is
scaled by sqrt(d_model), then a final norm and an untied unembedding.
The departures from the published model are the program's, listed in
the configuration file (``departures``).  Imports nothing of the
program.
"""
from __future__ import annotations

import torch

from portbench.reference import common


def logits(weights: dict, config: dict, tokens: torch.Tensor,
           first_out: int, precision: str = "f32") -> torch.Tensor:
    """(R, S - first_out, V) float32 logits of every position from
    ``first_out`` on, for ``tokens`` (R, S) on the weights' device."""
    m, eps = config["model"], config["assumed"]["rms_eps"]
    stack = weights["groups"]["b0"]
    n_layers = stack["ln1"].shape[0]
    if n_layers != m["n_layers"] or set(weights["groups"]) != {"b0"}:
        raise ValueError("dense reference: one stacked block per layer")
    with common.float32_matmuls(), torch.no_grad():
        x = common.embed(weights, tokens, m["d_model"])
        for i in range(n_layers):
            x = common.attention_block(common.layer(stack, i), x, m, eps,
                                       precision)
        return common.head(weights, x[:, first_out:], eps, precision)
