"""PyTorch port on the card: the CUDA kernels K1-K5, each with its 2-input
body and its covariate (3-input) body, against their plain versions.

These tests need an NVIDIA card and skip without one.  The file imports no
JAX, so on a machine with a card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from conditional_ude_tpu_torch.analysis.profiles import cohort_beta_profiles
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    population_grad,
    rk4_cohort,
    rk4_population,
    tsit5_cohort,
)

pytestmark = pytest.mark.cuda
TP = (0.0, 30.0, 60.0, 90.0, 120.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _huge(input_dims):
    """ΔG-to-head weights of 1e20: on a rising glucose curve the trajectory
    leaves float32."""
    w1 = np.zeros((4, input_dims))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def _lanes(n_lanes, device, seed=3, input_dims=2):
    """Random per-lane weights (Glorot scale), cohort (real ages, 30-70) and
    β; the last lane's weights are huge on a rising glucose curve, so its
    SSE is inf.  The kinetics carry the age column for 3 inputs."""
    rng = np.random.default_rng(seed)
    net = chain(4, 2, input_dims=input_dims)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (n_lanes, fo * fi)), np.zeros((n_lanes, fo))]
    nn = np.concatenate(parts, axis=1)
    nn[-1] = _huge(input_dims)
    glucose = 5.0 + rng.uniform(0, 5, (n_lanes, 5))
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    cohort = build_cohort(glucose, np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (n_lanes, 5)),
                          rng.uniform(30, 70, n_lanes),
                          rng.uniform(size=n_lanes) > 0.5, device)
    f32 = dict(dtype=torch.float32, device=device)
    return net, (torch.as_tensor(nn, **f32),
                 torch.as_tensor(rng.uniform(-3.0, 0.5, n_lanes), **f32),
                 cohort.glucose, cohort.cpeptide,
                 cohort.kinetics(with_age=input_dims == 3))


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


def test_profile_scan_takes_a_row_of_a_column_major_table(card):
    """The xl candidates are stored column-major, so a candidate's row has a
    stride: the profile scan makes it contiguous and launches K4."""
    rng = np.random.default_rng(11)
    cohort = build_cohort(5.0 + rng.uniform(0, 5, (6, 5)), np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (6, 5)),
                          rng.uniform(30, 70, 6), rng.uniform(size=6) > 0.5,
                          card)
    model = CPeptideModel(chain(4, 2), "conditional")
    table = torch.as_tensor(rng.uniform(-0.5, 0.5, (37, 9)),
                            dtype=torch.float32, device=card).t()
    assert table[4].stride() == (9,)
    before = rk4_cohort.launches
    strided = cohort_beta_profiles(model, table[4], cohort, steps=40)
    assert rk4_cohort.launches == before + 1
    dense = cohort_beta_profiles(model, table[4].clone(), cohort, steps=40)
    assert torch.equal(strided.values, dense.values)


def test_wrapper_raises_instead_of_falling_back(card):
    net, (nn, betas, g, d, kin) = _lanes(8, card)
    column_major = g.t().contiguous().t()
    with pytest.raises(ValueError):
        rk4_cohort.cohort_sse(net, nn, betas, column_major, d, kin, TP, 8)
    # the covariate net with 4-column kinetics raises; with the age column
    # it launches the 3-input body
    cov = chain(4, 2, input_dims=3)
    with pytest.raises(ValueError):
        rk4_cohort.cohort_sse(cov, torch.zeros(8, 41, device=card), betas, g,
                              d, kin, TP, 8)
    before = rk4_cohort.launches_age
    rk4_cohort.cohort_sse(cov, torch.zeros(8, 41, device=card), betas, g, d,
                          torch.ones(8, 5, device=card), TP, 8)
    assert rk4_cohort.launches_age == before + 1


def _restarts(r, n, device, seed=5, input_dims=2):
    """r restarts (Glorot weights, the last one huge) on n random subjects,
    the last of them on a rising glucose curve."""
    net, (nn, _, glucose, data, kin) = _lanes(max(r, n), device, seed,
                                              input_dims)
    nn = nn[:r].clone()
    nn[-1] = torch.as_tensor(_huge(input_dims), dtype=torch.float32,
                             device=device)
    betas = torch.as_tensor(np.random.default_rng(seed).uniform(-2, 0, (r, n)),
                            dtype=torch.float32, device=device)
    return net, (nn, betas, glucose[-n:].contiguous(), data[-n:].contiguous(),
                 kin[-n:].contiguous(), TP)


@pytest.mark.parametrize("r,n", [(1, 1), (37, 8), (4096, 57)])
def test_population_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card)
    before = rk4_population.launches
    out = rk4_population.population_sse(net, *args, 8)
    assert rk4_population.launches == before + 1
    ref = rk4_population.population_sse_reference(net, *args, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(out[-1]))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r,n", [(3, 5), (25, 57)])
def test_value_and_grad_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card)
    before = lane_grad.launches
    sse, gnn, gb = lane_grad.lane_sse_and_grad(net, *args, 8)
    assert lane_grad.launches == before + 1
    r_sse, r_gnn, r_gb = lane_grad.lane_sse_and_grad_reference(net, *args, 8)
    torch.cuda.synchronize()
    fin = torch.isfinite(r_sse)
    assert torch.equal(torch.isfinite(sse), fin) and not bool(fin[-1].all())
    torch.testing.assert_close(sse[fin], r_sse[fin], rtol=1e-4, atol=0)
    rows = torch.isfinite(r_gnn).all(-1)
    assert torch.equal(torch.isfinite(gnn).all(-1), rows)
    scale = r_gnn[rows].abs().amax(-1, keepdim=True).clamp_min(1e-6)
    assert float(((gnn[rows] - r_gnn[rows]) / scale).abs().max()) <= 2e-4
    torch.testing.assert_close(gb[:-1], r_gb[:-1], rtol=1e-4, atol=1e-6)


def test_population_sse_autograd_launches_once(card):
    net, (nn, betas, *cohort) = _restarts(4, 6, card)
    x = nn.clone().requires_grad_(True)
    before = lane_grad.launches
    f = lane_grad.PopulationSSE.apply(x, betas, net, *cohort, 8)
    f[:-1].sum().backward()
    assert lane_grad.launches == before + 1
    _, gnn, _ = lane_grad.population_sse_and_grad(net, nn, betas, *cohort, 8)
    torch.testing.assert_close(x.grad[:-1], gnn[:-1], rtol=0, atol=0)


@pytest.mark.parametrize("r,n", [(3, 6), (25, 57)])
def test_tsit5_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card)
    before = tsit5_cohort.launches
    sse, ok = tsit5_cohort.cohort_sse_tsit5(net, *args)
    assert tsit5_cohort.launches == before + 1
    r_sse, r_ok = tsit5_cohort.cohort_sse_tsit5_reference(net, *args)
    torch.cuda.synchronize()
    assert torch.equal(ok, r_ok) and not bool(ok[-1, -1])
    torch.testing.assert_close(sse[ok], r_sse[ok], rtol=2e-2, atol=1e-3)
    assert bool(torch.isinf(sse[~ok]).all())


@pytest.mark.parametrize("n_lanes", [37, 17_500])
def test_covariate_cohort_kernel_matches_plain(card, n_lanes):
    net, args = _lanes(n_lanes, card, input_dims=3)
    before = (rk4_cohort.launches, rk4_cohort.launches_age)
    out = rk4_cohort.cohort_sse(net, *args, TP, 8)
    assert (rk4_cohort.launches, rk4_cohort.launches_age) == (before[0],
                                                              before[1] + 1)
    ref = rk4_cohort.cohort_sse_reference(net, *args, TP, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(out[-1]))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r,n", [(37, 8), (4096, 57)])
def test_covariate_population_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card, input_dims=3)
    before = rk4_population.launches_age
    out = rk4_population.population_sse(net, *args, 8)
    assert rk4_population.launches_age == before + 1
    ref = rk4_population.population_sse_reference(net, *args, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(out[-1]))
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    torch.testing.assert_close(out[fin], ref[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r,n", [(3, 5), (25, 57)])
def test_covariate_value_and_grad_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card, input_dims=3)
    before = lane_grad.launches_age
    sse, gnn, gb = lane_grad.lane_sse_and_grad(net, *args, 8)
    assert lane_grad.launches_age == before + 1 and gnn.shape[-1] == 41
    r_sse, r_gnn, r_gb = lane_grad.lane_sse_and_grad_reference(net, *args, 8)
    torch.cuda.synchronize()
    fin = torch.isfinite(r_sse)
    assert torch.equal(torch.isfinite(sse), fin) and not bool(fin[-1].all())
    torch.testing.assert_close(sse[fin], r_sse[fin], rtol=1e-4, atol=0)
    rows = torch.isfinite(r_gnn).all(-1)
    assert torch.equal(torch.isfinite(gnn).all(-1), rows)
    scale = r_gnn[rows].abs().amax(-1, keepdim=True).clamp_min(1e-6)
    assert float(((gnn[rows] - r_gnn[rows]) / scale).abs().max()) <= 2e-4
    torch.testing.assert_close(gb[:-1], r_gb[:-1], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("r,n", [(3, 6), (25, 57)])
def test_covariate_tsit5_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card, input_dims=3)
    before = tsit5_cohort.launches_age
    sse, ok = tsit5_cohort.cohort_sse_tsit5(net, *args)
    assert tsit5_cohort.launches_age == before + 1
    r_sse, r_ok = tsit5_cohort.cohort_sse_tsit5_reference(net, *args)
    torch.cuda.synchronize()
    assert torch.equal(ok, r_ok) and not bool(ok[-1, -1])
    torch.testing.assert_close(sse[ok], r_sse[ok], rtol=2e-2, atol=1e-3)
    assert bool(torch.isinf(sse[~ok]).all())


def test_covariate_kernels_read_the_age(card):
    """Two cohorts that differ only in the age column give different results
    in each 3-input body."""
    net, (nn, betas, glucose, data, kin, _) = _restarts(6, 5, card,
                                                        input_dims=3)
    outs = []
    for age in (30.0, 70.0):
        k = kin.clone()
        k[:, 4] = age
        args = (nn[:-1].contiguous(), betas[:-1].contiguous(), glucose, data,
                k, TP)
        lanes = (nn[:-1].repeat_interleave(5, 0), betas[:-1].reshape(-1),
                 glucose.repeat(5, 1), data.repeat(5, 1), k.repeat(5, 1))
        outs.append((rk4_population.population_sse(net, *args, 8),
                     lane_grad.lane_sse_and_grad(net, *args, 8)[1],
                     tsit5_cohort.cohort_sse_tsit5(net, *args)[0],
                     rk4_cohort.cohort_sse(net, *lanes, TP, 8)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert not torch.equal(a, b)


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("r,n", [(1, 1), (37, 8), (130, 13), (600, 57)])
def test_restart_value_and_grad_kernel_matches_plain(card, r, n, input_dims):
    """K5 and K5c: value rtol 1e-4, gradients within 2e-4 of each row's
    largest, inf and non-finite rows in the same places."""
    net, args = _restarts(r, n, card, input_dims=input_dims)
    before = (population_grad.launches, population_grad.launches_age)
    f, gnn, gb = population_grad.restart_sse_and_grad(net, *args, 8)
    assert (population_grad.launches, population_grad.launches_age) == (
        before[0] + (input_dims == 2), before[1] + (input_dims == 3))
    assert gnn.shape == (r, net.num_params) and gb.shape == (r, n)
    r_f, r_gnn, r_gb = population_grad.restart_sse_and_grad_reference(
        net, *args, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(f[-1]))
    assert torch.equal(torch.isinf(f), torch.isinf(r_f))
    fin = torch.isfinite(r_f)
    torch.testing.assert_close(f[fin], r_f[fin], rtol=1e-4, atol=0)
    for got, ref in ((gnn, r_gnn), (gb, r_gb)):
        rows = torch.isfinite(ref).all(-1)
        assert torch.equal(torch.isfinite(got).all(-1), rows)
        scale = ref[rows].abs().amax(-1, keepdim=True).clamp_min(1e-6)
        if rows.any():
            assert float(((got[rows] - ref[rows]) / scale).abs().max()) <= 2e-4


@pytest.mark.parametrize("input_dims", [2, 3])
def test_restart_kernel_matches_the_packed_route(card, input_dims):
    """K5 against K2 and the sum outside it: two layouts of one function,
    equal up to the order of the sum over individuals.  The age is scaled
    by 1/100: raw ages saturate the first layer, and a saturated network's
    gradient terms cancel far below the magnitude float32 sums them at."""
    net, args = _restarts(300, 57, card, input_dims=input_dims)
    args = [args[0][:-1].contiguous(), args[1][:-1].contiguous(), *args[2:]]
    if input_dims == 3:
        args[4] = args[4].clone()
        args[4][:, 4] /= 100.0
    f, gnn, gb = population_grad.restart_sse_and_grad(net, *args, 8)
    p_f, p_gnn, p_gb = lane_grad.packed_sse_and_grad(net, *args, 8)
    torch.cuda.synchronize()
    torch.testing.assert_close(f, p_f, rtol=1e-4, atol=0)
    for got, ref in ((gnn, p_gnn), (gb, p_gb)):
        scale = ref.abs().amax(-1, keepdim=True).clamp_min(1e-6)
        assert float(((got - ref) / scale).abs().max()) <= 2e-4


def test_switch_takes_the_restart_kernel_above_the_lane_limit(card,
                                                              monkeypatch):
    """``population_sse_and_grad`` launches K2 up to ``PACK_MAX_LANES``
    lanes and K5 above, and nothing else."""
    net, args = _restarts(6, 5, card)
    counts = lambda: (lane_grad.launches, population_grad.launches)  # noqa: E731
    before = counts()
    lane_grad.population_sse_and_grad(net, *args, 8)
    assert counts() == (before[0] + 1, before[1])
    monkeypatch.setattr(lane_grad, "PACK_MAX_LANES", 29)
    lane_grad.population_sse_and_grad(net, *args, 8)
    assert counts() == (before[0] + 1, before[1] + 1)
