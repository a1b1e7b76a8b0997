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
    _assert_same(out, ref)


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


# exp05's screens: 10,000 designs on its smallest (8) and largest (82)
# cohorts, 96 and 9 restarts a block
@pytest.mark.parametrize("r,n", [(1, 1), (37, 8), (37, 57), (4096, 57),
                                 (10_000, 8), (10_000, 82)])
def test_population_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card)
    before = rk4_population.launches
    out = rk4_population.population_sse(net, *args, 8)
    assert rk4_population.launches == before + 1
    ref = rk4_population.population_sse_reference(net, *args, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(out[-1]))
    _assert_same(out, ref)


@pytest.mark.parametrize("input_dims", [2, 3])
def test_population_kernel_is_the_in_order_mean_of_cohort_lanes(card,
                                                                input_dims):
    """K1 (K1c) equals K4's (K4c's) lanes on the same (restart, individual)
    pairs, summed over the individuals 0..N-1 in order and times 1/N, bit
    for bit: both evaluate the network at the same 69 points."""
    r, n = 37, 57
    net, args = _restarts(r, n, card, input_dims=input_dims)
    nn, betas, glucose, data, kin, _ = args
    out = rk4_population.population_sse(net, *args, 8)
    lanes = rk4_cohort.cohort_sse(
        net, nn.repeat_interleave(n, 0), betas.reshape(-1),
        glucose.repeat(r, 1), data.repeat(r, 1), kin.repeat(r, 1), TP, 8)
    mean = population_grad.sum_in_order(lanes.reshape(r, n)) \
        * np.float32(1.0 / n)
    torch.cuda.synchronize()
    assert bool(torch.isinf(out[-1]))
    _assert_same(out, torch.where(torch.isfinite(mean), mean, torch.inf))


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


# exp05's refinement: 10 restarts of 8 and of 82 subjects, 80 and 820 lanes
# (a ragged last block of 4 warps at 80)
@pytest.mark.parametrize("r,n", [(10, 8), (10, 82)])
def test_value_and_grad_kernel_is_its_plain_version_bit_for_bit(card, r, n):
    net, args = _restarts(r, n, card)
    before = lane_grad.launches
    out = lane_grad.lane_sse_and_grad(net, *args, 8)
    assert lane_grad.launches == before + 1
    ref = lane_grad.lane_sse_and_grad_reference(net, *args, 8)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(out[0][-1]).all())
    for got, want in zip(out, ref):
        _assert_same(got, want)


# exp_advi's steps at 4 substeps (37 points a lane): the test stage's 8
# sample rows over 35 subjects (280 lanes) and the joint stage's 25 x 4 rows
# over 57 (5,700)
@pytest.mark.parametrize("r,n", [(8, 35), (100, 57)])
def test_value_and_grad_kernel_at_4_substeps_is_its_plain_version(card, r, n):
    net, args = _restarts(r, n, card)
    before = lane_grad.launches
    out = lane_grad.lane_sse_and_grad(net, *args, 4)
    assert lane_grad.launches == before + 1
    ref = lane_grad.lane_sse_and_grad_reference(net, *args, 4)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(out[0][-1]).all())
    for got, want in zip(out, ref):
        _assert_same(got, want)


def test_population_sse_autograd_launches_once(card):
    """Training's loss: ``PopulationSSE`` over ``sharded_population_vg`` on
    a one-card mesh launches K2 once, and its backward is the kernel's
    gradient."""
    from conditional_ude_tpu_torch.parallel import make_mesh
    from conditional_ude_tpu_torch.parallel.mesh import sharded_population_vg
    net, (nn, betas, *cohort) = _restarts(4, 6, card)
    vg = sharded_population_vg(net, tuple(cohort), make_mesh(devices=[card]))
    x = nn.clone().requires_grad_(True)
    before = lane_grad.launches
    f = lane_grad.PopulationSSE.apply(x, betas, vg)
    f[:-1].sum().backward()
    assert lane_grad.launches == before + 1
    _, gnn, _ = lane_grad.population_sse_and_grad(net, nn, betas, *cohort, 8)
    torch.testing.assert_close(x.grad[:-1], gnn[:-1], rtol=0, atol=0)


def _assert_tsit5_exact(net, args):
    """K3 (K3c for 3 inputs) launched once, then bit for bit its plain
    version: the same ``ok`` mask, the huge-weight lane failed, inf where
    not ok, every SSE equal."""
    before = (tsit5_cohort.launches, tsit5_cohort.launches_age)
    sse, ok = tsit5_cohort.cohort_sse_tsit5(net, *args)
    launched = (tsit5_cohort.launches - before[0],
                tsit5_cohort.launches_age - before[1])
    assert launched == ((0, 1) if net.input_dims == 3 else (1, 0))
    r_sse, r_ok = tsit5_cohort.cohort_sse_tsit5_reference(net, *args)
    torch.cuda.synchronize()
    assert torch.equal(ok, r_ok) and not bool(ok[-1, -1])
    assert bool(torch.isinf(sse[~ok]).all())
    torch.testing.assert_close(sse, r_sse, rtol=0, atol=0)


# the re-rank's shapes at 25 and 2,304 restarts, a small one, the ragged
# 1,237 restarts of one subject, and exp05's 10 restarts of 8 and of 82
@pytest.mark.parametrize("r,n", [(3, 6), (25, 57), (2304, 57), (1237, 1),
                                 (10, 8), (10, 82)])
def test_tsit5_kernel_matches_plain(card, r, n):
    _assert_tsit5_exact(*_restarts(r, n, card))


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
    _assert_same(out, ref)


@pytest.mark.parametrize("r,n", [(37, 8), (37, 57), (4096, 57)])
def test_covariate_population_kernel_matches_plain(card, r, n):
    net, args = _restarts(r, n, card, input_dims=3)
    before = rk4_population.launches_age
    out = rk4_population.population_sse(net, *args, 8)
    assert rk4_population.launches_age == before + 1
    ref = rk4_population.population_sse_reference(net, *args, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(out[-1]))
    _assert_same(out, ref)


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


@pytest.mark.parametrize("r,n", [(3, 6), (25, 57), (2304, 57), (1237, 1)])
def test_covariate_tsit5_kernel_matches_plain(card, r, n):
    _assert_tsit5_exact(*_restarts(r, n, card, input_dims=3))


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


def _assert_same(got, ref):
    """Bit for bit, non-finite entries in the same places."""
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("r,n", [(130, 13), (2304, 57)])
def test_grad_kernels_equal_their_plain_versions_bit_for_bit(card, r, n,
                                                             input_dims):
    """K2 and K5 (K2c and K5c) each equal their plain versions bit for bit,
    and K5 equals K2's lanes summed over the individuals 0..N-1 in order,
    times 1/N: the warp's and the block's orders are written in the sources
    and followed by the plain versions."""
    net, args = _restarts(r, n, card, input_dims=input_dims)
    lanes = lane_grad.lane_sse_and_grad(net, *args, 8)
    for got, ref in zip(lanes,
                        lane_grad.lane_sse_and_grad_reference(net, *args, 8)):
        _assert_same(got, ref)
    restart = population_grad.restart_sse_and_grad(net, *args, 8)
    torch.cuda.synchronize()
    assert bool(torch.isinf(restart[0][-1]))
    for got, ref in zip(restart, population_grad.restart_sse_and_grad_reference(
            net, *args, 8)):
        _assert_same(got, ref)
    inv_n = np.float32(1.0 / n)
    mean = population_grad.sum_in_order(lanes[0]) * inv_n
    _assert_same(restart[0], torch.where(torch.isfinite(mean), mean, torch.inf))
    _assert_same(restart[1], population_grad.sum_in_order(lanes[1]) * inv_n)
    _assert_same(restart[2], lanes[2] * inv_n)


def test_restart_kernel_refuses_a_cohort_beyond_shared_memory(card):
    """K5 keeps the cohort and a table of N rows in one block's shared
    memory while they fit (54,268 bytes at 57 subjects, above the 48 KB
    default, so the launch opts in); past the card's 227 KB it refuses
    nothing: it takes the individuals in tiles, each summed into the same
    running sums, so 1,000 subjects launch once and equal the plain
    version bit for bit."""
    net, args = _restarts(3, 57, card)
    before = population_grad.launches
    population_grad.restart_sse_and_grad(net, *args, 8)
    assert population_grad.launches == before + 1
    net, args = _restarts(3, 1000, card)
    got = population_grad.restart_sse_and_grad(net, *args, 8)
    assert population_grad.launches == before + 2
    for g, want in zip(got, population_grad.restart_sse_and_grad_reference(
            net, *args, 8)):
        _assert_same(g, want)


def test_suppression_loss_on_the_card_matches_the_cpu(card):
    """The suppression model reaches no kernel: its RK4 loss at the 25
    restarts of the committed λ = 0.01 fit, eager on the card, equals the
    CPU's within rtol 1e-5 and the file's objectives within 1e-4 (JAX on
    the CPU misses them by 2.1e-5)."""
    from pathlib import Path

    from conditional_ude_tpu_torch.models import suppression as sup
    from conditional_ude_tpu_torch.suppression_pipeline import (
        DATA_SEED,
        GROUP_MEANS,
        TIMEPOINTS,
    )
    from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint
    ck = load_checkpoint(Path(__file__).resolve().parent.parent / "artifacts"
                         / "suppression_lambda=0.01.npz")[0]
    data, gt = sup.generate_data(GROUP_MEANS, (15, 3, 3, 3, 3, 10),
                                 TIMEPOINTS, 0.1,
                                 rng=np.random.default_rng(DATA_SEED),
                                 device=card)
    np.testing.assert_array_equal(gt, ck["gt_train"])
    net = sup.suppression_net()
    got = {}
    for dev in ("cpu", card):
        got[str(dev)] = sup.suppression_loss(
            net, torch.as_tensor(ck["nn_params"], device=dev),
            torch.as_tensor(ck["thetas"], device=dev), data, TIMEPOINTS,
            torch.full((25,), 0.01, device=dev)).cpu()
    torch.testing.assert_close(got[str(card)], got["cpu"], rtol=1e-5,
                               atol=0)
    assert np.abs(got[str(card)].numpy() / ck["objectives"] - 1).max() <= 1e-4


def test_suppression_graphed_value_and_grad_matches_eager(card):
    """The fits' value+grad replayed from a CUDA graph (``graphed_vg``)
    equals eager autograd at the same inputs, on the first inputs and on
    new ones copied in, within rtol 1e-5."""
    from conditional_ude_tpu_torch.fit.optim import _autograd_vg, graphed_vg
    from conditional_ude_tpu_torch.models import suppression as sup
    from conditional_ude_tpu_torch.suppression_pipeline import TIMEPOINTS
    net = sup.suppression_net()
    gen = torch.Generator().manual_seed(3)
    data = torch.rand(6, 3, 8, generator=gen).to(card) + 0.5
    lam = torch.full((4,), 0.01, device=card)

    def loss(x):
        return sup.suppression_loss(net, x[0], x[1], data, TIMEPOINTS, lam)

    first = tuple(a.to(card) for a in sup.initial_designs(net, 4, 6, gen))
    vg = graphed_vg(loss, first)
    for x in (first, tuple(a.to(card) for a in sup.initial_designs(
            net, 4, 6, gen))):
        f, grads = vg(x)
        want_f, want_g = _autograd_vg(loss)(x)
        torch.testing.assert_close(f, want_f, rtol=1e-5, atol=0)
        for g, w in zip(grads, want_g):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


def test_two_way_mesh_on_one_card_is_the_unsharded_run(card):
    """A 2-way mesh of ``cuda:0``: ``sharded_screen`` (K1 once a shard)
    and ``sharded_beta_profiles`` (K4 once a shard a chunk; 37 subjects, so
    the pad path) equal the unsharded launches bit for bit."""
    from conditional_ude_tpu_torch.parallel import (
        make_mesh,
        sharded_beta_profiles,
        sharded_screen,
    )
    from conditional_ude_tpu_torch.parallel.mesh import cohort_args
    net, (nn, betas, *_) = _lanes(64, card)
    rng = np.random.default_rng(17)
    cohort = build_cohort(5.0 + rng.uniform(0, 5, (37, 5)), np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (37, 5)),
                          rng.uniform(30, 70, 37), rng.uniform(size=37) > 0.5,
                          card)
    b_screen = torch.as_tensor(rng.uniform(-3, 0.5, (64, 37)),
                               dtype=torch.float32, device=card)
    mesh = make_mesh(("restarts",), devices=[card, card])
    plain = rk4_population.population_sse(net, nn, b_screen,
                                          *cohort_args(cohort, False))
    before = rk4_population.launches
    sharded = sharded_screen(net, nn, b_screen, cohort, mesh)
    assert rk4_population.launches == before + 2
    assert torch.equal(sharded, plain)

    model = CPeptideModel(net, "conditional")
    mesh_i = make_mesh(("individuals",), devices=[card, card])
    kw = dict(sigmas=0.2, lower=-3.0, upper=1.0, steps=300, chunk=100)
    p0 = cohort_beta_profiles(model, nn[0], cohort, **kw)
    before = rk4_cohort.launches
    p1 = sharded_beta_profiles(model, nn[0], cohort, mesh_i, **kw)
    assert rk4_cohort.launches == before + 6
    assert p1.values.shape == (37, 300)
    assert torch.equal(p1.values, p0.values)


# -- networks other than chain(4, 2): every body, one library a shape ---------

WIDE_NETS = {"W": ((8, 8), 2), "D": ((4, 4, 4), 2), "V": ((6, 3), 3),
             "W3": ((8, 8), 3), "chain(5, 1)": ((5,), 2),
             # past 127 weights: K2 and K5 sum the gradient in 2 and 4 passes
             "chain(12, 2)": ((12, 12), 2), "chain(20, 2)": ((20, 20), 2),
             "chain(20, 2) on 3 inputs": ((20, 20), 3)}


def _wide_case(name, device, r=25, n=57, seed=8):
    """Glorot weights of ``WIDE_NETS[name]`` for r restarts, β's and a
    cohort of n with real ages."""
    widths, d = WIDE_NETS[name]
    net = chain(list(widths), input_dims=d)
    rng = np.random.default_rng(seed)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (r, fo * fi)), np.zeros((r, fo))]
    cohort = build_cohort(5.0 + rng.uniform(0, 5, (n, 5)), np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (n, 5)),
                          rng.uniform(30, 70, n), rng.uniform(size=n) > 0.5,
                          device)
    f32 = dict(dtype=torch.float32, device=device)
    return net, (torch.as_tensor(np.concatenate(parts, 1), **f32),
                 torch.as_tensor(rng.uniform(-2.0, 0.0, (r, n)), **f32),
                 cohort.glucose, cohort.cpeptide,
                 cohort.kinetics(with_age=d == 3), TP)


@pytest.mark.parametrize("name", list(WIDE_NETS))
def test_every_body_at_another_network_is_its_plain_version(card, name):
    """K1, K4, K2, K5 and K3 (or their covariate bodies) at a network the
    JAX kernels take but the canonical library does not: each launches the
    library built for its shape once and equals its plain version bit for
    bit (K3 with the same ``ok`` mask)."""
    net, args = _wide_case(name, card)
    shape = (net.input_dims, net.widths)
    nn, betas, glucose, cpeptide, kin, tp = args
    r, n = betas.shape
    lanes = (nn.repeat_interleave(n, 0), betas.reshape(-1),
             glucose.repeat(r, 1), cpeptide.repeat(r, 1), kin.repeat(r, 1))
    calls = (
        (rk4_population, rk4_population.population_sse,
         rk4_population.population_sse_reference, args + (8,)),
        (rk4_cohort, rk4_cohort.cohort_sse, rk4_cohort.cohort_sse_reference,
         lanes + (tp, 8)),
        (lane_grad, lane_grad.lane_sse_and_grad,
         lane_grad.lane_sse_and_grad_reference, args + (8,)),
        (population_grad, population_grad.restart_sse_and_grad,
         population_grad.restart_sse_and_grad_reference, args + (8,)),
        (tsit5_cohort, tsit5_cohort.cohort_sse_tsit5,
         tsit5_cohort.cohort_sse_tsit5_reference, args))
    for mod, kernel, plain, a in calls:
        before = mod.shape_launches.get(shape, 0)
        out = kernel(net, *a)
        assert mod.shape_launches[shape] == before + 1
        ref = plain(net, *a)
        torch.cuda.synchronize()
        for o, p in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            torch.testing.assert_close(o, p, rtol=0, atol=0, equal_nan=True)


def _train_wide(device, widths, config):
    """``train_conditional`` of ``chain(widths)`` on a cohort of 57 from
    seed 9: ``(result, launches of its shape by module)``."""
    from conditional_ude_tpu_torch.fit.train import train_conditional

    net = chain(list(widths))
    rng = np.random.default_rng(9)
    n = 57
    cohort = build_cohort(5.0 + rng.uniform(0, 5, (n, 5)), np.asarray(TP),
                          0.5 + rng.uniform(0, 1.5, (n, 5)),
                          rng.uniform(30, 70, n), rng.uniform(size=n) > 0.5,
                          device)
    mods = (rk4_population, lane_grad, population_grad, tsit5_cohort)
    shape = (2, tuple(widths))
    before = [m.shape_launches.get(shape, 0) for m in mods]
    res = train_conditional(CPeptideModel(net, "conditional"), cohort,
                            config, seed=3)
    launched = {m.__name__.rsplit(".", 1)[1]: m.shape_launches.get(shape, 0)
                - b for m, b in zip(mods, before)}
    return res, launched


def test_training_takes_a_network_past_one_gradient_pass(card):
    """``chain(20, 2)`` (501 weights, whose gradient K2 sums in 4 passes of
    128 columns) trains through K1, K2 and K3 at 57 individuals: the
    objectives finite and the best below every restart's first Adam loss
    (Adam at its 1e-2 step first climbs on this network, L-BFGS then
    descends, as the plain route does on the CPU)."""
    from conditional_ude_tpu_torch.fit.train import TrainConfig

    res, launched = _train_wide(card, (20, 20), TrainConfig(
        initial_guesses=512, selected_initials=4, adam_iters=20,
        lbfgs_iters=5))
    assert (res.timings["screen_path"], res.timings["refine_path"]) == (
        "cuda_k1", "cuda_k2")
    assert launched["rk4_population"] == 1 and launched["tsit5_cohort"] == 1
    assert launched["lane_grad"] > 20 and launched["population_grad"] == 0
    assert bool(torch.isfinite(res.objectives).all())
    assert float(res.objectives[0]) < float(res.loss_traces[:, 0].min())


def test_training_at_2304_restarts_takes_the_restart_kernel_past_one_pass(
        card):
    """``chain(12, 2)`` (205 weights, 2 passes) at 2,304 restarts of 57
    individuals, 131,328 lanes, past ``PACK_MAX_LANES``: 3 Adam steps
    through K5 and none through K2, the best objective finite."""
    from conditional_ude_tpu_torch.fit.train import TrainConfig

    res, launched = _train_wide(card, (12, 12), TrainConfig(
        initial_guesses=2304, selected_initials=2304, adam_iters=3,
        lbfgs_iters=0))
    assert res.timings["refine_path"] == "cuda_k5"
    assert launched["population_grad"] >= 3 and launched["lane_grad"] == 0
    assert res.objectives.shape == (2304,)
    assert bool(torch.isfinite(res.objectives[0]))


# -- any time grid, substep count and cohort size (F9) -------------------------
#
# The JAX kernels unroll any grid and substep count and take any cohort; the
# port's bodies take them too: a grid of more than 16 points through the
# long-grid library (its tables in device memory), more than 16 substeps and
# a cohort past one block's shared memory through the layouts the launches
# choose.  Each is held to its plain version bit for bit.

def _fujita_times():
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    return tuple(float(t) for t in np.load(root / "artifacts" / "fujita.npz")
                 ["timepoints"])


GRIDS = {"25 points": tuple(np.linspace(0.0, 120.0, 25)),
         "61 points": tuple(np.linspace(0.0, 120.0, 61)),
         "fujita": _fujita_times(),          # 14 points from -10 min
         "121 points": tuple(np.linspace(0.0, 120.0, 121))}


def _grid_case(grid, r, n, device, input_dims=2, seed=21, widths=(4, 4)):
    """r restarts (Glorot, the last of huge weights) and n subjects (real
    ages, the last on a rising glucose curve) on the grid ``GRIDS[grid]``
    (or a tuple of times)."""
    tp = GRIDS[grid] if isinstance(grid, str) else tuple(grid)
    k = len(tp)
    net = chain(list(widths), input_dims=input_dims)
    rng = np.random.default_rng(seed)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (r, fo * fi)), np.zeros((r, fo))]
    nn = np.concatenate(parts, 1)
    if tuple(widths) == (4, 4):
        nn[-1] = _huge(input_dims)
    glucose = 5.0 + rng.uniform(0, 5, (n, k))
    glucose[-1] = np.linspace(5.0, 9.0, k)
    cohort = build_cohort(glucose, np.asarray(tp),
                          0.5 + rng.uniform(0, 1.5, (n, k)),
                          rng.uniform(30, 70, n), rng.uniform(size=n) > 0.5,
                          device)
    f32 = dict(dtype=torch.float32, device=device)
    return net, (torch.as_tensor(nn, **f32),
                 torch.as_tensor(rng.uniform(-2.0, 0.0, (r, n)), **f32),
                 cohort.glucose, cohort.cpeptide,
                 cohort.kinetics(with_age=input_dims == 3), tp)


def _lanes_of(args):
    """K4's lanes of the (restart, individual) pairs of restart inputs."""
    nn, betas, glucose, data, kin, tp = args
    r, n = betas.shape
    return (nn.repeat_interleave(n, 0), betas.reshape(-1),
            glucose.repeat(r, 1), data.repeat(r, 1), kin.repeat(r, 1), tp)


def _held(mod, kernel, plain, net, args):
    """The body launched once at the network's shape, bit for bit its plain
    version; returns the kernel's outputs."""
    shape = (net.input_dims, net.widths)
    before = mod.shape_launches.get(shape, 0)
    out = kernel(net, *args)
    assert mod.shape_launches[shape] == before + 1
    ref = plain(net, *args)
    torch.cuda.synchronize()
    for o, p in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _assert_same(o, p)
    return out


def _in_order(lanes, r, n):
    """K5's outputs from K2's lanes: summed over the individuals 0..N-1 in
    order and times 1/N."""
    sse, gnn, gb = lanes
    inv_n = np.float32(1.0 / n)
    mean = population_grad.sum_in_order(sse) * inv_n
    return (torch.where(torch.isfinite(mean), mean, torch.inf),
            population_grad.sum_in_order(gnn) * inv_n, gb * inv_n)


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("grid", ["25 points", "61 points", "fujita"])
def test_every_body_on_a_longer_grid_is_its_plain_version(card, grid,
                                                          input_dims):
    """K1, K4, K2, K5 and K3 (or their covariate bodies) on a grid of 25
    and 61 points (the long-grid library) and on Fujita's 14 points from
    -10 min: each launches once and equals its plain version bit for bit
    (K3 with the same ``ok`` mask); K5 also equals K2's lanes summed in
    order and K1 the in-order mean of K4's lanes."""
    net, args = _grid_case(grid, 25, 57, card, input_dims)
    r, n = args[1].shape
    k1 = _held(rk4_population, rk4_population.population_sse,
               rk4_population.population_sse_reference, net, args + (8,))
    k4 = _held(rk4_cohort, rk4_cohort.cohort_sse,
               rk4_cohort.cohort_sse_reference, net, _lanes_of(args) + (8,))
    mean = population_grad.sum_in_order(k4.reshape(r, n)) * np.float32(1 / n)
    _assert_same(k1, torch.where(torch.isfinite(mean), mean, torch.inf))
    k2 = _held(lane_grad, lane_grad.lane_sse_and_grad,
               lane_grad.lane_sse_and_grad_reference, net, args + (8,))
    k5 = _held(population_grad, population_grad.restart_sse_and_grad,
               population_grad.restart_sse_and_grad_reference, net,
               args + (8,))
    for got, want in zip(k5, _in_order(k2, r, n)):
        _assert_same(got, want)
    sse, ok = _held(tsit5_cohort, tsit5_cohort.cohort_sse_tsit5,
                    tsit5_cohort.cohort_sse_tsit5_reference, net, args)
    assert bool(torch.isinf(sse[~ok]).all()) and not bool(ok[-1].all())


def test_screen_and_rerank_take_121_points(card):
    """K1 and K3 at 121 points (a sample a minute): nothing refused, each
    bit for bit its plain version."""
    net, args = _grid_case("121 points", 37, 57, card)
    _held(rk4_population, rk4_population.population_sse,
          rk4_population.population_sse_reference, net, args + (8,))
    _held(tsit5_cohort, tsit5_cohort.cohort_sse_tsit5,
          tsit5_cohort.cohort_sse_tsit5_reference, net, args)


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("grid,substeps", [("ogtt", 20), ("ogtt", 32),
                                           ("61 points", 32),
                                           ("121 points", 32)])
def test_grad_kernels_past_16_substeps(card, grid, substeps, input_dims):
    """K2 and K5 at 20 and 32 substeps (up to 7,801 evaluation points a lane
    at 121 points, where a block of K2 takes fewer warps): bit for bit their
    plain versions, K5 K2's lanes summed in order; K1 and K4 alike."""
    r, n = (25, 57) if grid == "ogtt" else (3, 13)
    net, args = _grid_case(TP if grid == "ogtt" else grid, r, n, card,
                           input_dims)
    k2 = _held(lane_grad, lane_grad.lane_sse_and_grad,
               lane_grad.lane_sse_and_grad_reference, net, args + (substeps,))
    k5 = _held(population_grad, population_grad.restart_sse_and_grad,
               population_grad.restart_sse_and_grad_reference, net,
               args + (substeps,))
    for got, want in zip(k5, _in_order(k2, r, n)):
        _assert_same(got, want)
    _held(rk4_population, rk4_population.population_sse,
          rk4_population.population_sse_reference, net, args + (substeps,))


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("n", [1053, 2106])
def test_cohort_past_one_block(card, n, input_dims):
    """K1 and K5 at 1,053 and 2,106 individuals (past the 819 and 909 a
    block held before): K1 reads the cohort from device memory and sums a
    restart's chunks into one running total, K5 takes the individuals in
    tiles; both bit for bit their plain versions, K1 the in-order mean of
    K4's lanes and K5 K2's lanes summed in order."""
    net, args = _grid_case(TP, 5, n, card, input_dims)
    k1 = _held(rk4_population, rk4_population.population_sse,
               rk4_population.population_sse_reference, net, args + (8,))
    k4 = rk4_cohort.cohort_sse(net, *_lanes_of(args), 8)
    mean = population_grad.sum_in_order(k4.reshape(5, n)) * np.float32(1 / n)
    _assert_same(k1, torch.where(torch.isfinite(mean), mean, torch.inf))
    k5 = _held(population_grad, population_grad.restart_sse_and_grad,
               population_grad.restart_sse_and_grad_reference, net,
               args + (8,))
    for got, want in zip(k5, _in_order(
            lane_grad.lane_sse_and_grad(net, *args, 8), 5, n)):
        _assert_same(got, want)


@pytest.mark.parametrize("widths,n", [((4, 4), 1053), ((90, 90), 57)],
                         ids=["chain(4, 2) at 1053", "chain(90, 2) at 57"])
def test_restart_kernel_at_2304_restarts(card, widths, n):
    """K5 at 2,304 restarts (its route above ``PACK_MAX_LANES``) for
    ``chain(4, 2)`` on 1,053 individuals and for ``chain(90, 2)``, 8,551
    weights, past the 8,192 a block copies into shared memory (read from
    device memory, 67 passes of 128 columns): one launch, and the first,
    a middle and the last restarts bit for bit the plain version on those
    restarts alone (the restarts are independent)."""
    net, args = _grid_case(TP, 2304, n, card, widths=widths)
    assert net.num_params == (37 if widths == (4, 4) else 8551)
    shape = (2, tuple(widths))
    before = population_grad.shape_launches.get(shape, 0)
    got = population_grad.restart_sse_and_grad(net, *args, 8)
    assert population_grad.shape_launches[shape] == before + 1
    pick = torch.tensor([0, 1151, 2303], device=card)
    nn, betas, *cohort = args
    ref = population_grad.restart_sse_and_grad_reference(
        net, nn[pick], betas[pick], *cohort, 8)
    torch.cuda.synchronize()
    for g, want in zip(got, ref):
        _assert_same(g[pick], want)


@pytest.mark.parametrize("input_dims", [2, 3])
def test_grad_kernels_past_one_block_of_scratch(card, input_dims):
    """K2 and K5 at 7,200 substeps (57,605 evaluation points a lane, past
    what one warp's scratch can hold in a block's shared memory): the
    scratch in device memory, the outputs finite, K5 K2's lanes summed in
    order bit for bit, and the SSEs within 1e-3 of 32 substeps' (RK4 has
    converged)."""
    net, args = _grid_case(TP, 2, 3, card, input_dims, seed=4)
    args = (args[0][:1].contiguous(), args[1][:1].contiguous(), *args[2:])
    k2 = lane_grad.lane_sse_and_grad(net, *args, 7200)
    k5 = population_grad.restart_sse_and_grad(net, *args, 7200)
    for got, want in zip(k5, _in_order(k2, 1, 3)):
        _assert_same(got, want)
    assert all(bool(torch.isfinite(x).all()) for x in k2)
    coarse = lane_grad.lane_sse_and_grad(net, *args, 32)[0]
    torch.testing.assert_close(k2[0], coarse, rtol=1e-3, atol=0)
