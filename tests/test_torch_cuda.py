"""PyTorch port on the card: the CUDA kernel K4 against its plain version.

These tests need an NVIDIA card and skip without one.  The file imports no
JAX, so on a machine with a card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from conditional_ude_tpu_torch.models.cpeptide import build_cohort
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import rk4_cohort

pytestmark = pytest.mark.cuda
TP = (0.0, 30.0, 60.0, 90.0, 120.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _lanes(n_lanes, device, seed=3):
    """Random per-lane weights (Glorot scale), cohort and β; the last lane's
    ΔG-to-head weights are 1e20 on a rising glucose curve, so its SSE is inf."""
    rng = np.random.default_rng(seed)
    net = chain(4, 2)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (n_lanes, fo * fi)), np.zeros((n_lanes, fo))]
    nn = np.concatenate(parts, axis=1)
    w1 = np.zeros((4, 2))
    w1[:, 0] = 1e20
    nn[-1] = np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                             np.zeros(4), np.full(4, 1e20), [0.0]])
    glucose = 5.0 + rng.uniform(0, 5, (n_lanes, 5))
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    cohort = build_cohort(glucose, np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (n_lanes, 5)),
                          rng.uniform(30, 70, n_lanes),
                          rng.uniform(size=n_lanes) > 0.5, device)
    f32 = dict(dtype=torch.float32, device=device)
    return net, (torch.as_tensor(nn, **f32),
                 torch.as_tensor(rng.uniform(-3.0, 0.5, n_lanes), **f32),
                 cohort.glucose, cohort.cpeptide, cohort.kinetics())


@pytest.mark.parametrize("n_lanes", [1, 37, 1237, 58_500])
def test_kernel_matches_plain(card, n_lanes):
    net, args = _lanes(n_lanes, card)
    before = rk4_cohort.launches
    out = rk4_cohort.cohort_sse(net, *args, TP, 8)
    assert rk4_cohort.launches == before + 1
    ref = rk4_cohort.cohort_sse_reference(net, *args, TP, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(out[-1]))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=1e-5, atol=1e-6)


def test_shared_weights_stride0(card):
    net, (nn, *rest) = _lanes(257, card)
    shared = nn[0].expand(257, -1)
    out = rk4_cohort.cohort_sse(net, shared, *rest, TP, 8)
    dense = rk4_cohort.cohort_sse(net, shared.contiguous(), *rest, TP, 8)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)


def test_wrapper_raises_instead_of_falling_back(card):
    net, (nn, betas, g, d, kin) = _lanes(8, card)
    column_major = g.t().contiguous().t()
    with pytest.raises(ValueError):
        rk4_cohort.cohort_sse(net, nn, betas, column_major, d, kin, TP, 8)
    with pytest.raises(NotImplementedError):
        rk4_cohort.cohort_sse(chain(4, 2, input_dims=3),
                              torch.zeros(8, 41, device=card), betas, g, d,
                              torch.ones(8, 5, device=card), TP, 8)
