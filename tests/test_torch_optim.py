"""PyTorch port: Adam over a leading restart axis (``fit/optim.py``) against
the JAX package's ``adam_minimize`` (optax) vmapped over the same rows."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conditional_ude_tpu.fit.losses import population_sse as jax_population_sse
from conditional_ude_tpu.fit.optim import adam_minimize as jax_adam
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.fit.losses import population_sse
from conditional_ude_tpu_torch.fit.optim import adam_minimize
from conditional_ude_tpu_torch.models.cpeptide import CPeptideModel, build_cohort
from conditional_ude_tpu_torch.nn import chain

RTOL = 1e-5
TP = (0.0, 30.0, 60.0, 90.0, 120.0)


def _quadratic_case():
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(4, 6)).astype(np.float32)
    c = rng.normal(size=(4, 6)).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, (4, 6)).astype(np.float32)
    return x0, c, scale


def test_quadratic_with_a_non_finite_gradient_matches_optax():
    """Row 0's gradient entry 2 is NaN on every step: Adam zeroes it, so
    that coordinate never moves, as in the JAX package."""
    x0, c, scale = _quadratic_case()
    nan_mask = np.zeros_like(x0, bool)
    nan_mask[0, 2] = True

    def j_vg(x, c_, s_, m_):
        f = jnp.sum(s_ * (x - c_) ** 2)
        g = 2.0 * s_ * (x - c_)
        return f, jnp.where(m_, jnp.nan, g)

    ref = jax.vmap(lambda x, c_, s_, m_: jax_adam(
        lambda x: jnp.sum(s_ * (x - c_) ** 2), x, iters=50, lr=0.05,
        fun_and_grad=lambda x: j_vg(x, c_, s_, m_)))(
        jnp.asarray(x0), jnp.asarray(c), jnp.asarray(scale),
        jnp.asarray(nan_mask))

    ct, st, mt = (torch.as_tensor(a) for a in (c, scale, nan_mask))

    def fun(x):
        return (st * (x[0] - ct) ** 2).sum(-1)

    def vg(x):
        g = 2.0 * st * (x[0] - ct)
        return fun(x), (torch.where(mt, torch.nan, g),)

    out = adam_minimize(fun, (torch.as_tensor(x0),), iters=50, lr=0.05,
                        fun_and_grad=vg)
    np.testing.assert_allclose(out.x[0].numpy(), np.asarray(ref.x), rtol=RTOL,
                               atol=1e-6)
    assert out.x[0][0, 2] == x0[0, 2]
    np.testing.assert_allclose(out.loss_trace.numpy(),
                               np.asarray(ref.loss_trace), rtol=RTOL)
    np.testing.assert_allclose(out.fval.numpy(), np.asarray(ref.fval),
                               rtol=RTOL)
    assert out.loss_trace.shape == (4, 50) and out.opt_state.count == 50


def test_autograd_route_and_resume_are_the_same_run():
    x0, c, scale = _quadratic_case()
    ct, st = torch.as_tensor(c), torch.as_tensor(scale)

    def fun(x):
        return (st * (x[0] - ct) ** 2).sum(-1)

    whole = adam_minimize(fun, (torch.as_tensor(x0),), iters=30, lr=0.05)
    half = adam_minimize(fun, (torch.as_tensor(x0),), iters=12, lr=0.05)
    rest = adam_minimize(fun, half.x, iters=18, lr=0.05,
                         opt_state=half.opt_state)
    torch.testing.assert_close(rest.x[0], whole.x[0], rtol=0, atol=0)
    torch.testing.assert_close(
        torch.cat([half.loss_trace, rest.loss_trace], 1), whole.loss_trace,
        rtol=0, atol=0)


def test_population_loss_matches_optax():
    """Ten Adam steps on the population RK4 loss, gradients by autograd in
    the port and by XLA autodiff in the JAX package."""
    rng = np.random.default_rng(8)
    n = 4
    raw = (5.0 + rng.uniform(0, 5, (n, 5)), np.asarray(TP),
           0.5 + rng.uniform(0, 1.5, (n, 5)), rng.uniform(30, 70, n),
           rng.uniform(size=n) > 0.5)
    jnet = jax_chain(4, 2, "tanh", input_dims=2)
    jmodel = jcp.CPeptideModel(kind="conditional", net=jnet)
    jc = jcp.build_cohort(*raw)
    nn = np.array(jnet.init_batch(jax.random.key(2), 2))
    betas = rng.uniform(-2.0, 0.0, (2, n)).astype(np.float32)

    def jloss(p):
        return jax_population_sse(jmodel, p["neural"], p["conditional"], jc,
                                  solver="rk4", substeps=8)

    ref = jax.vmap(lambda a, b: jax_adam(
        jloss, {"neural": a, "conditional": b[:, None]}, iters=10,
        lr=1e-2))(jnp.asarray(nn), jnp.asarray(betas))

    model = CPeptideModel(chain(4, 2))
    cohort = build_cohort(*raw, "cpu")
    out = adam_minimize(
        lambda x: population_sse(model, x[0][:, None, :], x[1], cohort,
                                 substeps=8),
        (torch.as_tensor(nn), torch.as_tensor(betas)), iters=10, lr=1e-2)
    np.testing.assert_allclose(out.x[0].numpy(), np.asarray(ref.x["neural"]),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(out.x[1].numpy(),
                               np.asarray(ref.x["conditional"])[..., 0],
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(out.loss_trace.numpy(),
                               np.asarray(ref.loss_trace), rtol=RTOL)
