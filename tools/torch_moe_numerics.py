#!/usr/bin/env python3
"""Where the MoE path's bf16 numerics part between the card and the CPU.

    python3 tools/torch_moe_numerics.py

Run on a CUDA card from the root of a checkout (it exits non-zero
without one).  Two parts, both at qwen3-moe-30b-a3b's full width with
seeded random weights:

1. One MoE block, S = 96: the share of the expert products' bf16 outputs
   (``torch.bmm``, the gather path's shapes) that differ by an ulp from a
   float64 product rounded to bf16, on the card and on the CPU; the
   bf16 SwiGLU activation (``layers.silu``) card against CPU; and the
   block's outputs outside ``rtol=1e-2, atol=5e-2`` for the card against
   the CPU and for two CPU runs that differ only in how the GEMMs round.
2. Four MoE layers, prefill 2 x 96 tokens and 8 greedy decode steps (the
   CPU's tokens fed to both): per layer, the tokens the card routes to
   another expert set than the CPU, and per decode step the logits' max
   |diff| and both greedy tokens.

Prints one JSON object as its last line, beside the card's name and
power limit.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-2, 5e-2


def compare(a, b) -> dict:
    a, b = a.float().cpu(), b.float().cpu()
    d = (a - b).abs()
    return {"max_abs_diff": float(d.max()),
            "differ": float((d > 0).float().mean()),
            "outside_tol": float((d > ATOL + RTOL * b.abs()).float().mean())}


def block_part(torch, cfg) -> dict:
    import numpy as np
    from repro_torch.models import layers, moe
    from repro_torch.pytree import tree_map

    p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
    pc = tree_map(lambda a: a.cuda(), p)
    x = torch.from_numpy(np.random.default_rng(96).standard_normal(
        (2, 96, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    out = {"block_card_vs_cpu": compare(moe.moe_block(pc, x.cuda(), cfg),
                                        moe.moe_block(p, x, cfg))}
    real = torch.bmm
    torch.bmm = lambda a, b: real(a.double(), b.double()).to(a.dtype)
    try:
        exact = moe.moe_block(p, x, cfg)
    finally:
        torch.bmm = real
    out["block_cpu_vs_cpu_float64_gemms"] = compare(moe.moe_block(p, x, cfg),
                                                    exact)
    xe = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (cfg.n_experts, 14, cfg.d_model)).astype(np.float32)).to(
            torch.bfloat16)
    up = torch.bmm(xe, p["w_up"])
    up64 = torch.bmm(xe.double(), p["w_up"].double()).to(torch.bfloat16)
    out["bmm_cpu_vs_float64"] = compare(up, up64)
    out["bmm_card_vs_float64"] = compare(torch.bmm(xe.cuda(), pc["w_up"]),
                                         up64)
    out["silu_card_vs_cpu"] = compare(layers.silu(up.cuda()),
                                      layers.silu(up))
    return out


def layers_part(torch, cfg) -> dict:
    import numpy as np
    from repro_torch.models import moe, transformer
    from repro_torch.pytree import tree_map

    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params = transformer.init_params(cfg4, seed=1, device="cuda")
    params_cpu = tree_map(lambda a: a.cpu(), params)
    rec, real = [], moe.moe_block

    def spy(p, x, c, return_routing=False):
        y, ix, probs = real(p, x, c, return_routing=True)
        rec.append(ix.sort(-1).values.cpu())
        return (y, ix, probs) if return_routing else y

    def routed(fn):
        rec.clear()
        result = fn()
        return result, list(rec)

    def flips(ra, rb):
        return [int((a != b).any(-1).sum()) for a, b in zip(ra, rb)]

    moe.moe_block = spy
    try:
        toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 96))
        (lg, cache), rg = routed(lambda: transformer.prefill(
            params, cfg4, {"tokens": toks}, 104))
        (lc, cache_c), rc = routed(lambda: transformer.prefill(
            params_cpu, cfg4, {"tokens": toks}, 104))
        out = {"prefill_flips_per_layer": flips(rg, rc),
               "prefill_tokens": 2 * 96, "steps": []}
        for t in range(8):            # step 0 reads the prefill's logits
            top = lc.topk(2, dim=-1).values
            out["steps"].append({
                "flips_per_layer": flips(rg, rc),
                "logits_max_abs_diff": float((lg.float().cpu() - lc).abs()
                                             .max()),
                "gap": (top[:, 0] - top[:, 1]).tolist(),
                "card_token": lg.argmax(-1).tolist(),
                "cpu_token": lc.argmax(-1).tolist()})
            nxt = lc.argmax(-1)[:, None].numpy()
            (lg, cache), rg = routed(lambda: transformer.decode_step(
                params, cfg4, nxt, cache, 96 + t))
            (lc, cache_c), rc = routed(lambda: transformer.decode_step(
                params_cpu, cfg4, nxt, cache_c, 96 + t))
    finally:
        moe.moe_block = real
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible: this script measures the card")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = get_arch("qwen3-moe-30b-a3b")
    doc = {"card": smi, "block": block_part(torch, cfg),
           "layers": layers_part(torch, cfg)}
    print(smi)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
