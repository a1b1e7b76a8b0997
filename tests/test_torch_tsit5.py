"""PyTorch port: adaptive Tsit5 — the solver ``ops/tsit5.py`` and the
re-rank kernel K3 (``ops/tsit5_cohort.py``).

On the CPU K3's wrapper runs its plain PyTorch version.  Both are held
against the JAX package's Pallas Tsit5 kernel in interpret mode and its XLA
Tsit5 path at the JAX suite's own tolerance (``tests/test_pallas_tsit5.py``:
rtol 2e-2, atol 1e-3; an accept/reject decision can flip on one ulp, so the
step sequences may differ), with the same ``ok`` mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditional_ude_tpu.fit.losses import sse as jax_sse
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_rk4 import cohort_kinetics, expand_to_lanes
from conditional_ude_tpu.ops.pallas_tsit5 import cohort_sse_tsit5_pallas
from conditional_ude_tpu.ops.tsit5 import solve_tsit5 as jax_solve_tsit5
from conditional_ude_tpu_torch.fit.losses import sse
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import tsit5_cohort
from conditional_ude_tpu_torch.ops.tsit5 import solve_tsit5

R, N = 3, 6
TP = (0.0, 30.0, 60.0, 90.0, 120.0)
RTOL, ATOL = 2e-2, 1e-3


@pytest.fixture(scope="module")
def case():
    """R restarts on an N-subject cohort; the last subject's glucose rises
    and the last restart's weights from ΔG to the head are huge, so that
    lane fails."""
    rng = np.random.default_rng(5)
    glucose = 5.0 + rng.uniform(0, 5, (N, 5))
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    raw = (glucose, np.asarray(TP), 0.5 + rng.uniform(0, 1.5, (N, 5)),
           rng.uniform(30, 70, N), rng.uniform(size=N) > 0.5)
    jc = jcp.build_cohort(*raw)
    jnet = jax_chain(4, 2, "tanh", input_dims=2)
    nn = np.array(jnet.init_batch(jax.random.key(1), R))
    w1 = np.zeros((4, 2))
    w1[:, 0] = 1e20
    nn[-1] = np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                             np.zeros(4), np.full(4, 1e20), [0.0]])
    betas = rng.uniform(-2.0, 0.0, (R, N)).astype(np.float32)
    kin = np.asarray(cohort_kinetics(jc, with_age=False))
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    args = (t(nn), t(betas), t(jc.individuals.glucose), t(jc.cpeptide),
            t(kin), TP)
    return jnet, jc, raw, nn, betas, args


def _pallas(jnet, jc, nn, betas):
    lanes = expand_to_lanes(jnp.asarray(nn), jnp.asarray(betas), jc)
    s, ok = cohort_sse_tsit5_pallas(jnet, *lanes, interpret=True)
    return np.asarray(s).reshape(R, N), np.asarray(ok).reshape(R, N)


def _xla(jnet, jc, nn, betas):
    model = jcp.CPeptideModel(kind="conditional", net=jnet)
    return np.asarray(jax.vmap(lambda n_, b_: jax.vmap(
        lambda b, ind, d: jax_sse(model, {"neural": n_, "conditional": b},
                                  ind, jc.timepoints, d, solver="tsit5"))(
        b_, jc.individuals, jc.cpeptide))(jnp.asarray(nn), jnp.asarray(betas)))


def test_kernel_plain_matches_pallas_interpret(case):
    jnet, jc, _, nn, betas, args = case
    before = tsit5_cohort.launches
    s, ok = tsit5_cohort.cohort_sse_tsit5(chain(4, 2), *args)
    assert tsit5_cohort.launches == before      # the CPU path launches nothing
    s_ref, ok_ref = _pallas(jnet, jc, nn, betas)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    assert not ok_ref[-1, -1] and ok_ref[:-1].all()
    np.testing.assert_array_equal(np.isinf(s.numpy()), ~ok_ref)
    np.testing.assert_allclose(s.numpy()[ok_ref], s_ref[ok_ref], rtol=RTOL,
                               atol=ATOL)


def test_kernel_plain_matches_xla_tsit5(case):
    jnet, jc, _, nn, betas, args = case
    s, ok = tsit5_cohort.cohort_sse_tsit5(chain(4, 2), *args)
    ref = _xla(jnet, jc, nn, betas)
    np.testing.assert_array_equal(np.isinf(ref), ~ok.numpy())
    okn = ok.numpy()
    np.testing.assert_allclose(s.numpy()[okn], ref[okn], rtol=RTOL, atol=ATOL)


def test_solver_matches_xla_tsit5_and_pallas(case):
    jnet, jc, raw, nn, betas, _ = case
    cohort = build_cohort(*raw, "cpu")
    out = sse(CPeptideModel(chain(4, 2)), torch.as_tensor(nn)[:, None, :],
              torch.as_tensor(betas), cohort, solver="tsit5").numpy()
    ref = _xla(jnet, jc, nn, betas)
    s_pal, ok_pal = _pallas(jnet, jc, nn, betas)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(np.isinf(out), ~ok_pal)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out[fin], s_pal[fin], rtol=RTOL, atol=ATOL)


def test_solver_step_sequence_matches_jax_on_a_linear_ode():
    """y' = A y with a shared scalar time grid: the same step counts and the
    same saved states as the JAX solver."""
    a = np.array([[-0.3, 0.1], [0.05, -0.02]], np.float32)
    y0 = np.array([1.0, 2.0], np.float32)
    saveat = np.array([0.0, 7.0, 30.0, 60.0], np.float32)
    ref = jax_solve_tsit5(lambda t, y, _: jnp.asarray(a) @ y, jnp.asarray(y0),
                          0.0, 60.0, None, jnp.asarray(saveat))
    at = torch.as_tensor(a)
    out = solve_tsit5(lambda t, y: y @ at.T, torch.as_tensor(y0)[None], 0.0,
                      60.0, saveat)
    assert bool(out.success[0]) and bool(ref.success)
    assert int(out.num_steps[0]) == int(ref.num_steps)
    assert int(out.num_accepted[0]) == int(ref.num_accepted)
    np.testing.assert_allclose(out.ys[0].numpy(), np.asarray(ref.ys),
                               rtol=1e-5, atol=1e-6)


def test_screen_population_is_the_mean_with_inf_for_failed_lanes(case):
    _, _, _, _, _, args = case
    s, ok = tsit5_cohort.cohort_sse_tsit5(chain(4, 2), *args)
    pop = tsit5_cohort.screen_population_tsit5(chain(4, 2), *args)
    torch.testing.assert_close(pop[:-1], s[:-1].mean(1), rtol=0, atol=0)
    assert bool(torch.isinf(pop[-1]))


def test_steps_are_counted_and_capped(case):
    _, _, _, _, _, args = case
    _, ok, steps, _ = tsit5_cohort.cohort_sse_tsit5_reference(
        chain(4, 2), *args, max_steps=40, return_steps=True)
    assert int(steps.max()) <= 40 and bool((steps[ok] > 4).all())


def test_constants_layout():
    c = tsit5_cohort.constants(TP, 1e-3, 1e-6)
    assert c.shape == (130,) and c.dtype == np.float32
    np.testing.assert_array_equal(c[78:83], np.float32(TP))
    np.testing.assert_array_equal(c[94:98], np.float32([30.0] * 4))
    # t0, t1, span, rtol, atol after the two blend weights
    np.testing.assert_array_equal(c[112:117],
                                  np.float32([0.0, 120.0, 120.0, 1e-3, 1e-6]))
