"""PyTorch port: ``parallel/dryrun.py::dryrun_mesh``, the counterpart of
``__graft_entry__.py::dryrun_multichip``, on CPU meshes of 2 and 5 devices:
every sharded subsystem runs at its tiny shapes, and SAEM's ``nll_trace``
is held to the unsharded run within atol 1e-4 inside it.  No JAX."""

import pytest
import torch

from conditional_ude_tpu_torch.parallel.dryrun import dryrun_mesh


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of tiny operations, one thread: more threads beside the
    other test processes only slow them and those processes down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("k", [2, 5])
def test_dryrun_mesh(k):
    report = dryrun_mesh(["cpu"] * k)
    assert report["devices"] == k
    assert set(report["exercised"]) == {
        "train_2d", "train_fused_pad", "screen", "census", "suppression",
        "saem"}
