"""The port's partition-spec rules (``repro_torch/dist/sharding.py``,
``train/step.py`` ``state_specs``) against the reference's, leaf for leaf:
all ten architectures at full size (shapes only, nothing allocated) on
four meshes — host (1, 1), (4, 1), the 16 x 16 single pod and the
2 x 16 x 16 multi-pod.  The reference's rules read only a mesh's axis
names and ``devices.shape``, so a stub stands in for the 512 devices.
Every comparison is exact."""
from __future__ import annotations

import functools

import numpy as np
import pytest

import jax  # noqa: F401  (the reference's shape evaluation)

from repro import configs as r_configs
from repro.dist import sharding as r_sharding
from repro.launch import specs as r_specs
from repro.train import step as r_step

from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.train import step as t_step

MESHES = {
    "host": (("data", "model"), (1, 1)),
    "host4": (("data", "model"), (4, 1)),
    "single": (("data", "model"), (16, 16)),
    "multi": (("pod", "data", "model"), (2, 16, 16)),
}
ARCHS = sorted(configs.ARCHS)


class _StubMesh:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, axis_names, shape):
        self.axis_names = axis_names
        self.devices = np.empty(shape)


def _meshes(kind):
    names, shape = MESHES[kind]
    return _StubMesh(names, shape), Mesh(names, shape)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = r_configs.get_arch(arch)
    cache, _, _ = r_specs.decode_arg_specs(cfg, r_configs.get_shape(
        "decode_32k"))
    return (r_specs.params_shapes(cfg), r_specs.state_shapes(cfg),
            r_specs.train_batch_specs(cfg, r_configs.get_shape("train_4k")),
            cache)


def assert_specs_equal(want, got, path=()):
    """``got`` (the port's tuples) equals ``want`` (the reference's
    PartitionSpecs) key for key and entry for entry."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got)
        for k in want:
            assert_specs_equal(want[k], got[k], path + (k,))
        return
    assert type(got) is tuple, (path, got)
    assert tuple(want) == got, (path, want, got)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, mesh_kind):
    r_mesh, mesh = _meshes(mesh_kind)
    r_params, r_state, r_batch, r_cache = _ref_shapes(arch)
    cfg = configs.get_arch(arch)
    shapes = specs.params_shapes(cfg)
    for two_d in (False, True):
        want = r_sharding.param_specs(r_params, r_mesh, two_d_mlp=two_d)
        assert_specs_equal(want, sharding.param_specs(shapes, mesh,
                                                      two_d_mlp=two_d))
    # the (shape, dtype) leaves of transformer.param_shapes give the same
    assert_specs_equal(r_sharding.param_specs(r_params, r_mesh),
                       sharding.param_specs(transformer.param_shapes(cfg),
                                            mesh))
    assert_specs_equal(
        r_sharding.batch_specs(r_batch, r_mesh),
        sharding.batch_specs(specs.train_batch_specs(
            cfg, configs.get_shape("train_4k")), mesh))
    cache, _, _ = specs.decode_arg_specs(cfg, configs.get_shape("decode_32k"))
    for seq_shard in (False, True):
        assert_specs_equal(
            r_sharding.cache_specs(r_cache, r_mesh, seq_shard=seq_shard),
            sharding.cache_specs(cache, mesh, seq_shard=seq_shard))
    assert_specs_equal(r_step.state_specs(r_state, r_mesh),
                       t_step.state_specs(specs.state_shapes(cfg), mesh))


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_guard_drops_unshardable_dims(mesh_kind):
    """The reference's ``test_divisibility_guard_drops_unshardable_dims``
    on each mesh, and the reference's own answer."""
    r_mesh, mesh = _meshes(mesh_kind)
    got = sharding._guard(("data", "model"), (3, 5), mesh)
    n_data = dict(zip(mesh.axis_names, mesh.shape))["data"]
    if 3 % n_data != 0:
        assert got[0] is None
    assert got == tuple(r_sharding._guard(("data", "model"), (3, 5), r_mesh))
    assert len(got) == 2
    # axis tuples and short axis lists, as the decode token spec uses them
    dp = sharding.dp_axes(mesh)
    for axes, shape in [((dp, None), (128, 1)), ((dp,), (32, 7)),
                        (("model",), (256,)), ((("data", "model"),), (512,))]:
        assert sharding._guard(axes, shape, mesh) == tuple(
            r_sharding._guard(axes, shape, r_mesh)), (axes, shape)


def test_meshes():
    single = make_production_mesh()
    multi = make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == \
        (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, multi.shape, multi.size) == \
        (("pod", "data", "model"), (2, 16, 16), 512)
    assert make_host_mesh(4) == Mesh(("data", "model"), (4, 1))
    assert sharding.dp_axes(multi) == ("pod", "data")
    assert sharding.dp_axes(single) == "data"
    with pytest.raises(ValueError):
        Mesh(("data",), (2, 2))


def test_host_mesh_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="n_devices"):
        make_host_mesh()


# ---------------------------------------------------------------------------
# The raw gather (``sharding._Gather``) on a (2, 2) mesh of four gloo
# processes (``tests/_torch_mesh_mp_ranks.py gather``), against DTensor's
# own redistribution of the same placed tensor.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    from test_torch_mesh_model_parallel import finish_ranks, start_ranks
    import _torch_mesh_mp_ranks as mp
    work = tmp_path_factory.mktemp("gather")
    return finish_ranks("gather", start_ranks("gather", mp.GATHER_WORLD,
                                              work), work)


@pytest.mark.parametrize("name", ["full", "replicate_dim", "redistribute"])
@pytest.mark.parametrize("case", ["shard0_shard1", "shard1_shard1",
                                  "shard2_replicate", "partial_shard0",
                                  "shard2_partial", "partial_partial",
                                  "replicate_shard", "shard_to_shard",
                                  "shard_outside", "partial_to_shard"])
def test_raw_gather_matches_dtensor(gathered, case, name):
    """Values (exact but for the order of a partial sum's adds) and the
    gradient of a weighted sum, on every process; the raw path (new
    splits by the raw cut, ``Shard(a)`` -> ``Shard(b)`` as gather then
    cut) meets no functional all-gather in either pass."""
    for r, got in enumerate(gathered):
        key = f"{case}/{name}"
        np.testing.assert_allclose(got[f"{key}/raw"], got[f"{key}/dtensor"],
                                   rtol=1e-6, atol=1e-6, err_msg=(r, key))
        np.testing.assert_array_equal(got[f"{key}/raw_grad"],
                                      got[f"{key}/dtensor_grad"],
                                      err_msg=(r, key))
        assert int(got[f"{key}/raw_functional"]) == 0, (r, key)


@pytest.mark.parametrize("case", ["rows_columns", "heads", "split_sequence",
                                  "whole_x"])
def test_row_parallel_matches_dtensor(gathered, case):
    """``layers.row_parallel`` on each process's blocks (the attention
    output's heads folded into the contraction; a split sequence takes
    the weight whole) against the product of the operands DTensor made
    whole: values and both operands' gradients within float32 rounding
    (the partial sums add in another order), with no functional
    all-gather."""
    for r, got in enumerate(gathered):
        key = f"row/{case}"
        for part in ("", "_grad_x", "_grad_w"):
            np.testing.assert_allclose(
                got[f"{key}/raw{part}"], got[f"{key}/dtensor{part}"],
                rtol=1e-5, atol=1e-5, err_msg=(r, key, part))
        assert int(got[f"{key}/raw_functional"]) == 0, (r, key)


def test_gather_columns_in_block_order(gathered):
    """Two activations of one dtype, split over both mesh dimensions
    (process c0 * 2 + c1 holds block c0 * 2 + c1), gathered by one raw
    all-gather."""
    want0 = np.concatenate([np.arange(6.0).reshape(2, 3) + 10 * r
                            for r in range(4)], axis=1)
    want1 = np.concatenate([np.arange(2.0).reshape(2, 1) - 10 * r
                            for r in range(4)], axis=1)
    for got in gathered:
        np.testing.assert_array_equal(got["columns/0"], want0)
        np.testing.assert_array_equal(got["columns/1"], want1)
