"""Run the reference's train step over a (2, 2) ("data", "model") mesh of
four host devices and dump what the port's mesh training is held to
(helper of tests/test_torch_mesh_train.py; not collected).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/_ref_train_mesh_dump.py OUT.npz

For each arch of ``ARCHS`` the state of ``init_state(PRNGKey(0))`` is
placed as the reference's launcher places it (``device_put`` onto
``to_named(state_specs)``), and each leaf's shard on the device at each
mesh position (row-major, the port's rank order) is dumped.  For each
case of ``CASES`` one jitted step (``in_shardings=(named, None)``, as
the launcher runs it) on ``case_batch(...)`` gives ``loss``,
``grad_norm``, ``lr`` and the full state after the step.  The
int8-compressed sum runs ``PSUM_ROUNDS`` rounds of
``compressed_psum_leaf`` over a four-device ``("data",)`` axis, each
device summing its own row of ``psum_input(...)``, and dumps each
round's sum and every device's residual.
"""
from __future__ import annotations

import sys

import numpy as np

ARCHS = ("yi-9b", "zamba2-2.7b")
#: name -> (arch, attn_seq_shard, microbatches); a step takes BATCH rows
#: per microbatch (the port's ranks then meet one set of shapes per arch)
CASES = {"yi": ("yi-9b", False, 1), "yi_mb2": ("yi-9b", False, 2),
         "yi_seq": ("yi-9b", True, 1), "zamba2": ("zamba2-2.7b", False, 1)}
SEQ, BATCH, SEED = 32, 4, 5
PSUM_ROUNDS, PSUM_WIDTH = 8, 512


def psum_input() -> np.ndarray:
    """(4, PSUM_WIDTH) float32: device k's gradient is row k."""
    return np.random.default_rng(3).normal(
        size=(4, PSUM_WIDTH)).astype(np.float32)


def case_batch(pipeline, name: str, vocab_size: int) -> dict:
    """Case ``name``'s global batch (numpy) from either package's
    ``data/pipeline.py``: ``BATCH`` rows per microbatch, step 0."""
    mb = CASES[name][2]
    return pipeline.batch_at(pipeline.DataConfig(
        vocab_size, SEQ, BATCH * mb, SEED), 0)


def leaf_paths(tree) -> list:
    """``("a/b/c", leaf)`` in ``jax.tree.leaves`` order (keys sorted)."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, v) for k in sorted(tree)
                for p, v in leaf_paths(tree[k])]
    return [("", tree)]


def arch_cfg(arch: str, seq_shard: bool = False):
    import dataclasses

    from repro import configs
    cfg = configs.get_arch(arch).reduced()
    if seq_shard:
        cfg = dataclasses.replace(cfg, attn_seq_shard=("data",))
    return cfg


def main(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.data import pipeline
    from repro.dist import compression, sharding
    from repro.train import optimizer as opt
    from repro.train import step as step_mod

    assert len(jax.devices()) == 4, jax.devices()
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    pos = {d: i for i, d in enumerate(mesh.devices.flat)}
    out = {}

    def placed_state(cfg):
        state = step_mod.init_state(jax.random.PRNGKey(0), cfg)
        specs = step_mod.state_specs(jax.eval_shape(lambda: state), mesh)
        named = sharding.to_named(specs, mesh)
        return jax.tree.map(jax.device_put, state, named), named

    with mesh:
        for arch in ARCHS:
            state, _ = placed_state(arch_cfg(arch))
            for p, leaf in leaf_paths(state):
                out[f"{arch}/init/{p}"] = np.asarray(leaf)
                for shard in leaf.addressable_shards:
                    out[f"{arch}/shard{pos[shard.device]}/{p}"] = \
                        np.asarray(shard.data)
        for name, (arch, seq_shard, mb) in CASES.items():
            cfg = arch_cfg(arch, seq_shard)
            state, named = placed_state(cfg)
            batch = {k: jnp.asarray(v) for k, v in
                     case_batch(pipeline, name, cfg.vocab_size).items()}
            fn = jax.jit(step_mod.make_train_step(cfg, opt.OptConfig(), mb),
                         in_shardings=(named, None))
            state, metrics = fn(state, batch)
            for k, v in metrics.items():
                out[f"{name}/metric/{k}"] = np.asarray(v)
            for p, leaf in leaf_paths(state):
                out[f"{name}/after/{p}"] = np.asarray(leaf)

    flat = Mesh(np.asarray(jax.devices()), ("data",))
    fm = shard_map(        # eager, as tests/test_torch_distribution.py
        lambda a, r: tuple(x[None] for x in compression.compressed_psum_leaf(
            a[0], r[0], "data")),
        mesh=flat, in_specs=(P("data"), P("data")),
        out_specs=(P(), P("data")), check_rep=False)
    g = jnp.asarray(psum_input())
    r = jnp.zeros_like(g)
    for i in range(PSUM_ROUNDS):
        total, r = fm(g, r)
        out[f"psum/{i}/sum"] = np.asarray(total)[0]
        out[f"psum/{i}/residual"] = np.asarray(r)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
