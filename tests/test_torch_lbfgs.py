"""PyTorch port: the batched L-BFGS, row by row against the JAX optimizer
``vmap``-ped over the same rows (the cases of ``tests/test_lbfgs.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs
from conditional_ude_tpu_torch.ops.lbfgs import lbfgs_minimize

X_ATOL, F_RTOL = 1e-4, 1e-5


class _NanGrad(torch.autograd.Function):
    """A finite (zero) objective whose gradient is NaN."""

    @staticmethod
    def forward(ctx, x):
        return (x**2).sum(-1) * 0.0

    @staticmethod
    def backward(ctx, g):
        return torch.full((g.shape[0], 2), torch.nan)


@jax.custom_vjp
def _jax_nan_grad(x):
    return jnp.sum(x**2) * 0.0


_jax_nan_grad.defvjp(lambda x: (_jax_nan_grad(x), x),
                     lambda x, g: (jnp.full_like(x, jnp.nan),))

A = np.array([1.0, 10.0, 100.0], np.float32)

# name: (torch f(x[R, p], c[R]), jax f(x[p], c), x0[R, p], c[R], kwargs)
CASES = {
    "quadratic": (
        lambda x, c: 0.5 * (x**2 * torch.as_tensor(A)).sum(-1)
        - (x * torch.stack([c, -2 * c, 3 * c], -1)).sum(-1),
        lambda x, c: 0.5 * jnp.sum(x**2 * A) - x @ jnp.stack([c, -2 * c, 3 * c]),
        np.zeros((4, 3)), np.array([1.0, 0.5, -1.0, 2.0]),
        dict(max_iters=100)),
    "rosenbrock": (
        lambda x, c: (c - x[:, 0]) ** 2 + 100.0 * (x[:, 1] - x[:, 0] ** 2) ** 2,
        lambda x, c: (c - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2,
        np.tile([-1.2, 1.0], (3, 1)), np.array([1.0, 0.8, 1.2]),
        dict(max_iters=300)),
    "box": (
        lambda x, c: ((x - c[:, None]) ** 2).sum(-1),
        lambda x, c: jnp.sum((x - c) ** 2),
        np.zeros((4, 2)), np.array([2.0, 0.5, -3.0, 0.9]),
        dict(max_iters=100, lower=[-1.0, -1.0], upper=[1.0, 1.0])),
    "shifted_lanes": (
        lambda x, c: ((x - c[:, None]) ** 2).sum(-1),
        lambda x, c: jnp.sum((x - c) ** 2),
        np.zeros((8, 2)), np.linspace(-2.0, 2.0, 8),
        dict(max_iters=50)),
    "inf_region": (
        lambda x, c: torch.where(x[:, 0] < 1.5, (x[:, 0] - c) ** 2, torch.inf),
        lambda x, c: jnp.where(x[0] < 1.5, (x[0] - c) ** 2, jnp.inf),
        np.zeros((3, 1)), np.array([1.0, 0.5, 1.4]),
        dict(max_iters=100)),
    "inf_at_start": (
        lambda x, c: torch.where(x[:, 0] > 0, (x[:, 0] - c) ** 2, torch.inf),
        lambda x, c: jnp.where(x[0] > 0, (x[0] - c) ** 2, jnp.inf),
        np.array([[-1.0], [1.0], [-0.5]]), np.array([0.0, 0.5, 0.5]),
        dict(max_iters=50)),
    "nan_gradient": (
        lambda x, c: _NanGrad.apply(x) + 0.0 * c,
        lambda x, c: _jax_nan_grad(x) + 0.0 * c,
        np.array([[1.0, -2.0], [0.5, 0.5]]), np.zeros(2),
        dict(max_iters=20)),
    "wolfe_patience": (
        lambda x, c: 0.5 * c * x[:, 0] ** 2 + 0.5 * x[:, 1] ** 2,
        lambda x, c: 0.5 * c * x[0] ** 2 + 0.5 * x[1] ** 2,
        np.ones((2, 2)), np.array([1e6, 1e4]),
        dict(max_iters=200, wolfe_patience=2, gtol=1e-8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_match_vmapped_jax(name):
    tf, jf, x0, c, kw = CASES[name]
    x0 = x0.astype(np.float32)
    c = c.astype(np.float32)
    tkw = {k: (torch.tensor(v, dtype=torch.float32)
               if k in ("lower", "upper") else v) for k, v in kw.items()}
    jkw = {k: (jnp.asarray(v, jnp.float32) if k in ("lower", "upper") else v)
           for k, v in kw.items()}

    ct = torch.as_tensor(c)
    res = lbfgs_minimize(lambda x: tf(x, ct), torch.as_tensor(x0), **tkw)
    ref = jax.vmap(lambda x, cc: jax_lbfgs(lambda z: jf(z, cc), x, **jkw))(
        jnp.asarray(x0), jnp.asarray(c))

    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=X_ATOL)
    f, jf_ = res.fval.numpy(), np.asarray(ref.fval)
    np.testing.assert_array_equal(np.isfinite(f), np.isfinite(jf_))
    fin = np.isfinite(jf_)
    np.testing.assert_allclose(f[fin], jf_[fin], rtol=F_RTOL, atol=1e-12)
    # the port stops a row at a fixed point; JAX runs it on to max_iters
    assert (res.num_iters.numpy() <= np.asarray(ref.num_iters)).all()


def test_known_minima():
    """The JAX suite's own expectations, held by the port directly."""
    quad, _, x0, c, kw = CASES["quadratic"]
    res = lbfgs_minimize(lambda x: quad(x, torch.ones(1)),
                         torch.zeros(1, 3), max_iters=100)
    assert bool(res.converged[0])
    np.testing.assert_allclose(res.x[0].numpy(), [1.0, -0.2, 0.03],
                               rtol=1e-4, atol=1e-5)

    box = CASES["box"][0]
    res = lbfgs_minimize(lambda x: box(x, torch.full((1,), 2.0)),
                         torch.zeros(1, 2), lower=torch.tensor([-1.0, -1.0]),
                         upper=torch.tensor([1.0, 1.0]), max_iters=100)
    np.testing.assert_allclose(res.x[0].numpy(), [1.0, 1.0], atol=1e-5)
    assert bool(res.converged[0])

    nan = CASES["nan_gradient"][0]
    res = lbfgs_minimize(lambda x: nan(x, torch.zeros(2)),
                         torch.tensor([[1.0, -2.0], [0.5, 0.5]]), max_iters=20)
    assert not res.converged.any()
    assert torch.isfinite(res.x).all()


def test_rows_are_independent():
    """A row's result does not depend on which rows share its batch."""
    f = CASES["rosenbrock"][0]
    c = torch.tensor([1.0, 0.8, 1.2])
    x0 = torch.tensor([[-1.2, 1.0]] * 3)
    full = lbfgs_minimize(lambda x: f(x, c), x0, max_iters=300)
    one = lbfgs_minimize(lambda x: f(x, c[1:2]), x0[1:2], max_iters=300)
    torch.testing.assert_close(full.x[1:2], one.x, rtol=0, atol=0)
    assert int(full.num_iters[1]) == int(one.num_iters[0])


def test_x0_must_be_rows():
    with pytest.raises(ValueError):
        lbfgs_minimize(lambda x: (x**2).sum(-1), torch.zeros(3))


def _state(v):
    from conditional_ude_tpu_torch.ops.lbfgs import _State

    x = torch.tensor([[v, -v]])
    return _State(x=x, f=x[:, 0] ** 2, g=x, gfin=torch.tensor([True]),
                  S=torch.zeros(1, 3, 2), Y=torch.zeros(1, 3, 2),
                  rho=torch.zeros(1, 3), valid=torch.zeros(1, 3, dtype=bool))


@pytest.mark.parametrize("max_iters", [10, 11, 12])
def test_orbit_end_picks_the_state_at_max_iters(max_iters):
    from conditional_ude_tpu_torch.ops.lbfgs import _orbit_end

    a, b, c = _state(1.0), _state(2.0), _state(3.0)
    it = torch.tensor([6])
    active = torch.tensor([True])
    # period 3: states 3..6 are a b c a; state n+k = state n-3+k
    found, end = _orbit_end(a, [b, c, a, b, c], active, it, max_iters)
    assert bool(found[0])
    want = [a, b, c][(max_iters - 6) % 3]
    assert float(end.x[0, 0]) == float(want.x[0, 0])
    # nothing repeats: the row goes on
    found, end = _orbit_end(a, [b, c], active, it, max_iters)
    assert not bool(found[0]) and float(end.x[0, 0]) == 1.0


def test_orbit_of_period_12_is_recognised():
    """Row 66 of the Ohashi (b, σ) fit orbits with period 12 on the H100
    (``scripts/fit_probe.py --trace 66``): the history kept holds it, and
    the row's state after ``max_iters`` is the orbit's."""
    from conditional_ude_tpu_torch.ops.lbfgs import CYCLE, _orbit_end

    assert CYCLE >= 12
    orbit = [_state(float(v)) for v in range(1, 13)]
    past = (orbit * 2)[-CYCLE:]
    it, max_iters = torch.tensor([41]), 1000
    found, end = _orbit_end(orbit[0], past, torch.tensor([True]), it,
                            max_iters)
    assert bool(found[0])
    assert float(end.x[0, 0]) == float(orbit[(max_iters - 41) % 12].x[0, 0])


def test_orbit_shortcut_leaves_results_unchanged(monkeypatch):
    """Rows stopped at a repeated state end exactly where running on to
    max_iters ends them."""
    from conditional_ude_tpu_torch.ops import lbfgs as port

    f = CASES["rosenbrock"][0]
    # some of these rows end at float32 fixed points short of gtol
    c = torch.tensor(np.random.default_rng(0).uniform(0.5, 1.5, 64),
                     dtype=torch.float32)
    x0 = torch.tensor([[-1.2, 1.0]] * 64)
    short = port.lbfgs_minimize(lambda x: f(x, c), x0, max_iters=300)
    monkeypatch.setattr(port, "_orbit_end",
                        lambda s, past, active, it, n: (
                            torch.zeros_like(active), s))
    full = port.lbfgs_minimize(lambda x: f(x, c), x0, max_iters=300)
    assert (short.num_iters < full.num_iters).any()
    torch.testing.assert_close(short.x, full.x, rtol=0, atol=0)
    torch.testing.assert_close(short.fval, full.fval, rtol=0, atol=0)
    assert torch.equal(short.converged, full.converged)
