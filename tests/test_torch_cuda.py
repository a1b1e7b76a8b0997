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
    memory: 54,116 bytes at 57 subjects (above the 48 KB default, so the
    launch opts in); the launch refuses a cohort past the card's 227 KB,
    which the wrapper raises as ``ValueError``, with no fallback."""
    net, args = _restarts(3, 57, card)
    before = population_grad.launches
    population_grad.restart_sse_and_grad(net, *args, 8)
    assert population_grad.launches == before + 1
    net, args = _restarts(3, 1000, card)
    with pytest.raises(ValueError):
        population_grad.restart_sse_and_grad(net, *args, 8)
    assert population_grad.launches == before + 1


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
