"""PyTorch port: the plain version of K5 (and K5c), the value+grad with a
block a restart, at networks other than the canonical ``chain(4, 2)``,
against the JAX package's restart gradient kernel
(``pallas_grad.py::_population_sse_and_grad_impl``) in interpret mode.

The cases are ``tests/test_torch_widths_kernels.py``'s: W = ``chain(8,
2)``, D = ``chain(4, 3)``, V = ``chain([6, 3], input_dims=3)`` and
``chain(5, 1)`` at 3 restarts x 4 individuals on the OGTT grid at 2
substeps; the value within rtol 1e-4 and each gradient within 2e-4 of a
row's largest entry (``tests/test_pallas_grad.py:61-64``).  JAX's restart
kernel loops over the individuals inside its body, which interpret mode
takes ~10-45 s a network to run, so these cases have a file of their own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_widths_kernels import (
    GRAD_RTOL,
    NETS,
    SUBSTEPS,
    TP,
    assert_grads_close,
    case,
)
from torch_threads import one_thread  # noqa: F401

import conditional_ude_tpu.ops.pallas_grad as jpg
from conditional_ude_tpu_torch.ops import lane_grad, population_grad


@pytest.mark.parametrize("name", list(NETS))
def test_restart_value_and_gradient_match_pallas(name):
    net, jnet, jc, nn, betas, kin, port = case(name)
    before = (population_grad.launches, population_grad.launches_age)
    f, gnn, gb = population_grad.restart_sse_and_grad(net, *port, SUBSTEPS)
    assert (population_grad.launches, population_grad.launches_age) == before
    assert gnn.shape == (betas.shape[0], net.num_params)
    f_r, gnn_r, gb_r = jpg._population_sse_and_grad_impl(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc.individuals.glucose,
        jc.cpeptide, jnp.asarray(kin), TP, SUBSTEPS, True)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=GRAD_RTOL)
    assert_grads_close(gnn, gnn_r)
    assert_grads_close(gb, gb_r)
    # K5's plain version is K2's plain lanes summed over the individuals in
    # order, at every network
    sse, g_lanes, gb_lanes = lane_grad.lane_sse_and_grad_reference(
        net, *port, SUBSTEPS)
    inv_n = np.float32(1.0 / betas.shape[1])
    assert (population_grad.sum_in_order(g_lanes) * inv_n).equal(gnn)
    assert (gb_lanes * inv_n).equal(gb)
