"""PyTorch port: the stage layout of the adaptive Tsit5 re-rank kernel K3.

The production term does not depend on the ODE state, so an attempted step
of K3 (``csrc/tsit5_cohort.cu``) and of its plain version
(``ops/tsit5_cohort.py::cohort_sse_tsit5_reference``) evaluates the network
at the step's five stage times first, then runs the stages' 2-state
recurrence; stage 7 takes stage 6's production, and the glucose at a time
comes from its one segment.  Held here on the CPU, no JAX needed:

- stage 6's time t + c6·dtc is stage 7's t + dtc in float32 (c6 = c7 = 1);
- the one-segment lookup ``glucose_at`` equals the JAX kernel's chain of
  ``where`` over all segments (kept below as the oracle) bit for bit;
- the plain version equals the formulation it replaced, six right-hand
  sides in a chain with the chain lookup (kept below as the oracle), bit
  for bit in SSE, ``ok`` and attempted and accepted steps (the counts
  ``chip_smoke.py`` takes for K3's bound), for both input counts;
- a lane evaluates the network 1 + 2 + 5·(attempted steps) times, the
  count ``chip_smoke.py`` takes for K3's bound;
- the kernel's host constants are built once per grid and are read-only.

Inputs come from numpy generators with the seed stated in each test.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import tsit5 as tableau
from conditional_ude_tpu_torch.ops import tsit5_cohort
from conditional_ude_tpu_torch.ops.rk4_cohort import (
    _mlp_columns,
    _mlp_forward,
    _segments,
)
from conditional_ude_tpu_torch.ops.tsit5 import f32

OHASHI = (0.0, 30.0, 60.0, 90.0, 120.0)
# 14 knots of uneven spans, the first before t = 0
UNEVEN = (-7.5, 0.0, 2.0, 5.0, 11.0, 12.5, 20.0, 33.0, 34.0, 47.5, 61.0,
          80.0, 99.0, 120.0)


def _chain_glucose(t, glucose, timepoints):
    """The JAX kernel's lookup, as K3's plain version had it: a chain of
    where(t >= knot[j], segment j, value) over every segment."""
    ts = np.asarray(timepoints, np.float64)
    spans = [torch.tensor(f32(ts[j + 1] - ts[j])) for j in range(len(ts) - 1)]
    val = glucose[:, 0].expand_as(t)
    for j in range(len(ts) - 1):
        lo = f32(ts[j])
        w = torch.clamp((t - lo) / spans[j], 0.0, 1.0)
        seg = (1.0 - w) * glucose[:, j] + w * glucose[:, j + 1]
        val = torch.where(t >= lo, seg, val)
    return val


def _chain_reference(net, nn_params, betas, glucose, data, kinetics,
                     timepoints, max_steps=256, rtol=1e-3, atol=1e-6):
    """The formulation K3's plain version replaced, kept as the oracle:
    six right-hand sides in a chain per attempted step, each with the
    network and the chain lookup.  Returns ``(sse, ok, steps, accepted)``:
    the steps each lane attempted and those it accepted."""
    ts = np.asarray(timepoints, np.float64)
    n_save = ts.shape[0]
    t0_f, t1_f = float(ts[0]), float(ts[-1])
    span = t1_f - t0_f
    _, j0, one_minus_w0, w0 = _segments(timepoints, 1)
    layers = _mlp_columns(nn_params, net)
    eb = torch.exp(betas)
    k0, k1, k2, c0 = (kinetics[:, i] for i in range(4))
    extra = [kinetics[:, 4]] if kinetics.shape[1] == 5 else []
    base = _mlp_forward(layers, [torch.zeros_like(eb), eb] + extra)
    A = [[f32(a) for a in row] for row in tableau._A]
    C = [f32(c) for c in tableau._C]
    BT = [f32(b) for b in tableau._BTILDE]
    g_at0 = one_minus_w0 * glucose[:, j0] + w0 * glucose[:, j0 + 1]

    def rhs(t, v1, v2):
        dg = _chain_glucose(t, glucose, timepoints) - g_at0
        prod = _mlp_forward(layers, [dg, eb] + extra) - base
        return (-(k0 + k2) * v1 + k1 * v2 + k0 * c0 + prod,
                -k1 * v2 + k2 * v1)

    def rms2(a1, a2, s1, s2):
        x1, x2 = a1 / s1, a2 / s2
        return torch.sqrt(f32(0.5) * (x1 * x1 + x2 * x2) + f32(1e-30))

    u1 = c0.expand_as(eb)
    u2 = (k2 / k1) * c0.expand_as(eb)
    t = torch.full_like(eb, f32(t0_f))
    f1a, f1b = rhs(t, u1, u2)
    s1 = f32(atol) + f32(rtol) * torch.abs(u1)
    s2 = f32(atol) + f32(rtol) * torch.abs(u2)
    d0 = rms2(u1, u2, s1, s2)
    d1 = rms2(f1a, f1b, s1, s2)
    small = (d0 < f32(1e-5)) | (d1 < f32(1e-5))
    h0 = torch.where(small, f32(1e-6),
                     f32(0.01) * d0 / torch.where(d1 == 0, 1.0, d1))
    h0 = torch.clamp_max(h0, f32(0.1 * span))
    f2a, f2b = rhs(t + h0, u1 + h0 * f1a, u2 + h0 * f1b)
    d2 = rms2(f2a - f1a, f2b - f1b, s1, s2) / h0
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= f32(1e-15),
                     torch.clamp_min(h0 * f32(1e-3), f32(1e-6)),
                     torch.pow(torch.full_like(dmax, f32(0.01)) / dmax,
                               f32(1.0 / (tableau.ORDER + 1.0))))
    dt = torch.minimum(f32(100.0) * h0, torch.clamp_max(h1, f32(span)))
    dt = torch.where(torch.isfinite(dt) & (dt > 0), dt, f32(1e-6 * span))

    sse = torch.square(u1 - data[:, 0])
    err_prev = torch.ones_like(eb)
    done = torch.zeros_like(eb, dtype=torch.bool)
    failed = torch.zeros_like(done)
    steps = torch.zeros_like(eb, dtype=torch.int32)
    accepted = torch.zeros_like(steps)
    dt_min = f32(1e-10 * span)
    save = [(si, f32(ts[si])) for si in range(n_save)
            if not math.isclose(float(ts[si]), t0_f)]

    for _ in range(max_steps):
        active = ~done & ~failed
        if not bool(active.any()):
            break
        steps = steps + active.int()
        dtc = torch.clamp_min(torch.minimum(dt, f32(t1_f) - t),
                              f32(1e-12 * span))
        ka, kb = [f1a], [f1b]
        for s in range(1, 6):
            va, vb = u1, u2
            for j in range(s):
                va = va + dtc * A[s][j] * ka[j]
                vb = vb + dtc * A[s][j] * kb[j]
            ra, rb = rhs(t + C[s] * dtc, va, vb)
            ka.append(ra)
            kb.append(rb)
        ya, yb = u1, u2
        for j in range(6):
            ya = ya + dtc * A[6][j] * ka[j]
            yb = yb + dtc * A[6][j] * kb[j]
        k7a, k7b = rhs(t + dtc, ya, yb)
        ka.append(k7a)
        kb.append(k7b)

        ea = BT[0] * ka[0]
        ebb = BT[0] * kb[0]
        for j in range(1, 7):
            ea = ea + BT[j] * ka[j]
            ebb = ebb + BT[j] * kb[j]
        ea, ebb = dtc * ea, dtc * ebb
        sc1 = f32(atol) + f32(rtol) * torch.maximum(torch.abs(u1),
                                                    torch.abs(ya))
        sc2 = f32(atol) + f32(rtol) * torch.maximum(torch.abs(u2),
                                                    torch.abs(yb))
        err = rms2(ea, ebb, sc1, sc2)

        finite = torch.isfinite(ya) & torch.isfinite(yb) & torch.isfinite(err)
        accept = finite & (err <= 1.0)
        err_c = torch.clamp_min(err, f32(1e-10))
        fac_acc = torch.clamp(
            f32(tableau.SAFETY) * torch.pow(err_c, f32(-tableau.BETA1))
            * torch.pow(err_prev, f32(tableau.BETA2)),
            f32(tableau.FACTOR_MIN), f32(tableau.FACTOR_MAX))
        fac_rej = torch.clamp(
            f32(tableau.SAFETY) * torch.pow(err_c, f32(-1.0 / tableau.ORDER)),
            f32(tableau.FACTOR_MIN), 1.0)
        factor = torch.where(accept, fac_acc,
                             torch.where(finite, fac_rej, 0.5))
        dt_next = dtc * factor

        t_new = t + dtc
        reached_end = t_new >= f32(t1_f - 1e-8 * span)
        upd = active & accept
        for si, t_s in save:
            hit = upd & (t_s > t) & ((t_s <= t_new) | reached_end
                                     & (t_s <= t_new + f32(1e-8 * span)))
            theta = torch.clamp((t_s - t) / dtc, 0.0, 1.0)
            bs = tableau._interp_coeffs(theta)
            yi = u1
            for j in range(7):
                yi = yi + dtc * bs[j] * ka[j]
            sse = torch.where(hit, sse + torch.square(yi - data[:, si]), sse)

        failed = failed | (active & ~accept & (dt_next < dt_min))
        accepted = accepted + upd.int()
        done = done | (upd & reached_end)
        t = torch.where(upd, t_new, t)
        dt = torch.where(active, dt_next, dt)
        u1 = torch.where(upd, ya, u1)
        u2 = torch.where(upd, yb, u2)
        f1a = torch.where(upd, k7a, f1a)
        f1b = torch.where(upd, k7b, f1b)
        err_prev = torch.where(upd, err_c, err_prev)

    ok = done & ~failed
    sse = torch.where(ok & torch.isfinite(sse), sse, torch.inf)
    return sse, ok, steps, accepted


def _huge(input_dims):
    """ΔG-to-head weights of 1e20: on a rising glucose curve the trajectory
    leaves float32, so the lane fails."""
    w1 = np.zeros((4, input_dims))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def _case(seed, input_dims, timepoints, r=4, n=5):
    """r restarts (Glorot-scale weights times 0.5-3, the last one huge) with
    β's on an n-subject cohort on ``timepoints``; the last subject's glucose
    rises.  Kinetics rows are van Cauter-like (k0, k1, k2, c0), with the age
    / 100 as a 5th column for 3 inputs."""
    rng = np.random.default_rng(seed)
    net = chain(4, 2, input_dims=input_dims)
    parts = []
    for fi, fo in net.layer_dims:
        b = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-b, b, (r, fo * fi)), np.zeros((r, fo))]
    nn = np.concatenate(parts, axis=1) * rng.uniform(0.5, 3.0, (r, 1))
    nn[-1] = _huge(input_dims)
    k = len(timepoints)
    glucose = 5.0 + rng.uniform(0.0, 5.0, (n, k))
    glucose[-1] = np.linspace(5.0, 9.0, k)
    data = 0.5 + rng.uniform(0.0, 1.5, (n, k))
    kin = np.stack([rng.uniform(0.04, 0.07, n), rng.uniform(0.03, 0.06, n),
                    rng.uniform(0.04, 0.07, n), rng.uniform(0.2, 1.2, n)], 1)
    if input_dims == 3:
        kin = np.concatenate([kin, rng.uniform(0.3, 0.7, (n, 1))], 1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return net, (t(nn), t(rng.uniform(-3.0, 0.5, (r, n))), t(glucose),
                 t(data), t(kin), timepoints)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_six_and_seven_share_their_time():
    """c6 = c7 = 1 in float32, so t + c6·dtc is t + dtc bit for bit and
    stage 7 may take stage 6's production."""
    c = [f32(v) for v in tableau._C]
    assert c[5] == 1.0 and c[6] == 1.0
    rng = np.random.default_rng(11)
    t = rng.uniform(-10.0, 240.0, 4096).astype(np.float32)
    dtc = np.exp(rng.uniform(-25.0, 5.0, 4096)).astype(np.float32)
    np.testing.assert_array_equal(t + np.float32(c[5]) * dtc, t + dtc)
    tt, dd = torch.as_tensor(t), torch.as_tensor(dtc)
    assert torch.equal(tt + c[5] * dd, tt + dd)


@pytest.mark.parametrize("timepoints", [OHASHI, UNEVEN],
                         ids=["ohashi", "uneven14"])
def test_one_segment_lookup_equals_the_where_chain(timepoints):
    """``glucose_at`` against the chain over every segment, bit for bit, at
    the knots, one float32 step either side of them, between them, outside
    the span and at non-finite times."""
    rng = np.random.default_rng(12)
    k = len(timepoints)
    knots = np.asarray(timepoints, np.float32)
    between = rng.uniform(knots[0] - 20.0, knots[-1] + 20.0, 400)
    t_all = np.concatenate([
        knots, np.nextafter(knots, -np.inf), np.nextafter(knots, np.inf),
        between, [knots[0] - 1e3, knots[-1] + 1e3, np.inf, -np.inf,
                  np.nan]]).astype(np.float32)
    n = 7
    glucose = torch.as_tensor((5.0 + rng.uniform(0, 10, (n, k))).astype(
        np.float32))
    t = torch.as_tensor(t_all).reshape(-1, 1).expand(-1, n).contiguous()
    kn, sp = tsit5_cohort.glucose_grid(timepoints, "cpu")
    got = tsit5_cohort.glucose_at(t, glucose, kn, sp)
    want = _chain_glucose(t, glucose, timepoints)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert torch.equal(got[fin], want[fin])


@pytest.mark.parametrize("input_dims", [2, 3])
@pytest.mark.parametrize("timepoints", [OHASHI, UNEVEN],
                         ids=["ohashi", "uneven14"])
def test_plain_version_equals_the_chain_formulation(input_dims, timepoints):
    """Productions first and the one-segment lookup change no arithmetic:
    SSE, ``ok`` and attempted and accepted steps equal the six-rhs chain's
    bit for bit, the huge-weight lane failing in both."""
    net, args = _case(13 + input_dims, input_dims, timepoints)
    sse, ok, steps, accepted = tsit5_cohort.cohort_sse_tsit5_reference(
        net, *args, return_steps=True)
    r_sse, r_ok, r_steps, r_accepted = _chain_reference(net, *args)
    assert torch.equal(ok, r_ok) and not bool(ok[-1, -1]) and bool(ok[0].all())
    assert torch.equal(steps, r_steps) and torch.equal(accepted, r_accepted)
    assert bool((accepted <= steps).all()) and bool((accepted[ok] > 0).all())
    assert torch.equal(sse, r_sse)


def test_each_lane_evaluates_the_network_three_times_plus_five_a_step(
        monkeypatch):
    """Counted in the plain version, one lane at a time (so calls × lanes is
    the lane's own count): ``_mlp_forward`` runs 1 + 2 + 5·(attempted
    steps) times, the count of ``chip_smoke.py::tsit5_evaluations``, and a
    lane alone attempts and accepts the steps it does among the others."""
    net, args = _case(21, 2, OHASHI, r=3, n=4)
    nn, betas, glucose, data, kin, tp = args
    _, _, steps, accepted = tsit5_cohort.cohort_sse_tsit5_reference(
        net, *args, return_steps=True)
    calls = []
    real = tsit5_cohort._mlp_forward

    def counted(layers, x):
        out = real(layers, x)
        calls.append(out.numel())
        return out

    monkeypatch.setattr(tsit5_cohort, "_mlp_forward", counted)
    count = _chip_smoke().tsit5_evaluations
    evaluations = 0
    for r in range(betas.shape[0]):
        for i in range(betas.shape[1]):
            calls.clear()
            _, _, s, acc = tsit5_cohort.cohort_sse_tsit5_reference(
                net, nn[r:r + 1], betas[r:r + 1, i:i + 1],
                glucose[i:i + 1], data[i:i + 1], kin[i:i + 1], tp,
                return_steps=True)
            assert int(s) == int(steps[r, i])
            assert int(acc) == int(accepted[r, i])
            assert set(calls) == {1}
            assert len(calls) == 3 + 5 * int(s) == count(1, int(s))
            evaluations += len(calls)
    assert evaluations == count(steps.numel(), int(steps.sum()))


def test_constants_are_built_once_per_grid_and_read_only():
    a = tsit5_cohort.constants(OHASHI, 1e-3, 1e-6)
    assert tsit5_cohort.constants(list(OHASHI), 1e-3, 1e-6) is a
    assert tsit5_cohort.constants(OHASHI, 1e-4, 1e-6) is not a
    assert a.dtype == np.float32 and a.shape == (130,)
    assert not a.flags.writeable
    with pytest.raises(ValueError):
        a[0] = 1.0
