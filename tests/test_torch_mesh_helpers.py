"""PyTorch port: the mesh's helpers (``parallel/mesh.py``) on the CPU,
``tests/test_parallel.py``'s mesh-shape and padding cases: ``make_mesh``,
``pad_to_multiple`` and ``pad_cohort`` held exactly to the JAX functions
on the same arrays, and ``shard_leading``'s split in mesh order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.parallel import mesh as jmesh
from conditional_ude_tpu_torch.models.cpeptide import build_cohort
from conditional_ude_tpu_torch.parallel import (
    make_mesh,
    pad_cohort,
    pad_to_multiple,
    shard_leading,
)

TP = np.array([0.0, 30.0, 60.0, 90.0, 120.0])


def raw_cohort(rng, n):
    """``test_parallel.py::_synthetic_cohort``'s arrays."""
    return (5 + rng.uniform(0, 5, (n, 5)), TP,
            0.5 + rng.uniform(0, 1.5, (n, 5)), rng.uniform(30, 70, n),
            np.zeros(n, bool))


def equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_make_mesh_shapes(monkeypatch):
    mesh = make_mesh(("restarts",), devices=["cpu"] * 8)
    assert mesh.shape == dict(jmesh.make_mesh(("restarts",)).shape)
    mesh2 = make_mesh(("restarts", "individuals"), (4, 2),
                      devices=["cpu"] * 8)
    jmesh2 = jmesh.make_mesh(("restarts", "individuals"), (4, 2))
    assert mesh2.shape == dict(jmesh2.shape) == {"restarts": 4,
                                                  "individuals": 2}
    assert mesh2.devices.shape == jmesh2.devices.shape
    assert len(mesh2.axis_devices("restarts")) == 4
    with pytest.raises(ValueError):
        jmesh.make_mesh(("restarts",), (3,))
    with pytest.raises(ValueError):
        make_mesh(("restarts",), (3,), devices=["cpu"] * 8)
    # no card: no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_mesh()


@pytest.mark.parametrize("multiple", [4, 5, 3])
def test_pad_to_multiple(multiple):
    x = np.arange(10.0, dtype=np.float32).reshape(5, 2)
    for axis, fill in ((0, None), (1, None), (0, -1.0)):
        got = pad_to_multiple(torch.as_tensor(x), multiple, axis, fill)
        equal(got, jmesh.pad_to_multiple(jnp.asarray(x), multiple, axis,
                                         fill))
    # pad_cohort against JAX's on the same cohort: every per-subject array
    rng = np.random.default_rng(2705)
    raw = raw_cohort(rng, 5)
    c = pad_cohort(build_cohort(*raw, "cpu"), multiple)
    jc = jmesh.pad_cohort(jcp.build_cohort(*raw), multiple)
    assert c.n == jc.n
    equal(c.glucose, jc.individuals.glucose)
    equal(c.cpeptide, jc.cpeptide)
    equal(c.age, jc.individuals.age)
    equal(c.kinetics(), np.stack([jc.individuals.k0, jc.individuals.k1,
                                  jc.individuals.k2, jc.individuals.c0], -1))


def test_shard_leading_splits_in_order():
    mesh = make_mesh(("restarts", "individuals"), (4, 2), devices=["cpu"] * 8)
    x = torch.arange(24.0).reshape(8, 3)
    parts = shard_leading({"a": x, "s": torch.tensor(2.0)}, mesh)
    assert len(parts) == 4
    equal(torch.cat([p["a"] for p in parts]), x)
    assert all(float(p["s"]) == 2.0 for p in parts)
    with pytest.raises(ValueError):
        shard_leading(torch.zeros(5, 2), mesh)
