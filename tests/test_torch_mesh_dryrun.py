"""PyTorch port: ``parallel/dryrun.py::dryrun_mesh``, the counterpart of
``__graft_entry__.py::dryrun_multichip``, on CPU meshes of 2 and 5 devices:
every sharded subsystem runs at its tiny shapes, and SAEM's ``nll_trace``
is held to the unsharded run within atol 1e-4 inside it.  No JAX."""

import pytest
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu_torch.parallel.dryrun import dryrun_mesh


@pytest.mark.parametrize("k", [2, 5])
def test_dryrun_mesh(k):
    report = dryrun_mesh(["cpu"] * k)
    assert report["devices"] == k
    assert set(report["exercised"]) == {
        "train_2d", "train_fused_pad", "screen", "census", "suppression",
        "saem"}
