"""Exact-equality helper shared by the port's model-state parity tests:
walks a JAX reference dataclass and its port counterpart field by field."""
from __future__ import annotations

import dataclasses

import numpy as np


def assert_tree_equal(want, got, path: str = "") -> None:
    """Every leaf of ``got`` (torch) equals the same-named leaf of ``want``
    (JAX), with the same shape and dtype."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_tree_equal(getattr(want, f.name), getattr(got, f.name),
                              f"{path}.{f.name}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_tree_equal(w, g, f"{path}[{i}]")
        return
    w = np.asarray(want)
    g = got.cpu().numpy()
    assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=path)
