"""PyTorch port: the flat-vector MLP against the JAX package's ``MLP.apply``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu_torch.convert import load_candidates, params_from_jax
from conditional_ude_tpu_torch.nn import chain, softplus

# rtol 1e-6; atol 1e-6 covers the softplus tail at pre-activations below
# about -14, where one float32 ulp of the pre-activation (XLA's and torch's
# tanh differ by a few) is a relative error of about 1e-6 in the output
RTOL, ATOL = 1e-6, 1e-6


def _weights(rng, net, n):
    """Glorot-scale weights; half the rows get an output bias of ±25, so
    head pre-activations lie past ±20, where F.softplus would be the
    identity."""
    parts = []
    for fi, fo in net.layer_dims:
        bound = np.sqrt(6.0 / (fi + fo))
        parts += [rng.uniform(-bound, bound, (n, fo * fi)),
                  rng.uniform(-0.5, 0.5, (n, fo))]
    flat = np.concatenate(parts, axis=1)
    flat[n // 2:, -1] += rng.choice([-25.0, 25.0], n - n // 2)
    return flat.astype(np.float32)


@pytest.mark.parametrize("widths,inputs", [((4, 4), 2), ((4, 4), 3),
                                           ((8,), 1), ((3, 5, 2), 2)])
def test_mlp_matches_jax(widths, inputs):
    rng = np.random.default_rng(7)
    net = chain(list(widths), activation="tanh", input_dims=inputs)
    jnet = jax_chain(list(widths), activation="tanh", input_dims=inputs)
    assert net.layer_dims == jnet.layer_dims
    assert net.num_params == jnet.num_params
    flat = _weights(rng, net, 256)
    x = np.concatenate([rng.uniform(-5.0, 10.0, (256, 1)),
                        rng.uniform(0.0, 3.0, (256, inputs - 1))],
                       axis=1).astype(np.float32)
    out = net.apply(torch.as_tensor(flat), torch.as_tensor(x)).numpy()
    ref = np.asarray(jnet.apply(jnp.asarray(flat), jnp.asarray(x)))
    assert out.shape == ref.shape == (256, 1)
    assert (out > 20).any()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_mlp_broadcasts_batch_dims():
    rng = np.random.default_rng(3)
    net = chain(4, 2)
    jnet = jax_chain(4, 2, "tanh", input_dims=2)
    flat = _weights(rng, net, 5)[:, None, :]            # [5, 1, P]
    x = rng.uniform(0.0, 3.0, (7, 2)).astype(np.float32)   # [7, 2]
    out = net.scalar(torch.as_tensor(flat), torch.as_tensor(x))
    ref = np.asarray(jnet.scalar(jnp.asarray(flat), jnp.asarray(x)))
    assert out.shape == (5, 7)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_softplus_matches_jax_above_threshold():
    import jax

    x = np.array([-100.0, -30.0, -20.5, -1.0, 0.0, 1e-3, 5.0, 20.0, 20.5,
                  30.0, 88.0, 100.0], np.float32)
    out = softplus(torch.as_tensor(x)).numpy()
    ref = np.asarray(jax.nn.softplus(x))
    normal = ref > np.finfo(np.float32).tiny    # XLA flushes denormals
    np.testing.assert_allclose(out[normal], ref[normal], rtol=RTOL)
    assert out[-1] == np.float32(100.0)


def test_candidate_row_loads_unchanged():
    nn, betas, idx_fit, orient = load_candidates(
        "artifacts/cude_neural_parameters.npz")
    assert nn.shape == (25, 37) and betas.shape == (25, 57, 1)
    assert idx_fit.shape == (57,) and orient.shape == (25,)
    net = chain(4, 2)
    row = params_from_jax(nn[19], net, "cpu")
    assert row.dtype == torch.float32
    np.testing.assert_array_equal(row.numpy(), nn[19])
    jlayers = jax_chain(4, 2, "tanh", input_dims=2).unflatten(
        jnp.asarray(nn[19]))
    for (w, b), (jw, jb) in zip(net.unflatten(row), jlayers):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_bad_parameter_count_raises():
    net = chain(4, 2)
    with pytest.raises(ValueError):
        net.apply(torch.zeros(36), torch.zeros(2))
    with pytest.raises(ValueError):
        params_from_jax(np.zeros(36, np.float32), net, "cpu")
