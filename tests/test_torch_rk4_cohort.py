"""PyTorch port: the cohort RK4 kernel K4 (``ops/rk4_cohort.py``).

On the CPU its wrapper runs the plain PyTorch version, which is held here
against the JAX package's Pallas kernel in interpret mode and against its
XLA RK4 path.  The CUDA kernel itself is held against the plain version by
``tests/test_torch_cuda.py``, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.fit.losses import sse as jax_sse
from conditional_ude_tpu.models import cpeptide as jcp
from conditional_ude_tpu.nn import chain as jax_chain
from conditional_ude_tpu.ops.pallas_rk4 import cohort_kinetics, cohort_sse_pallas
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.ops import rk4_cohort

# the JAX kernel and its XLA path already differ by 1.3e-5 from each other
RTOL, ATOL = 1e-4, 1e-6
LANES = 37          # ragged: not a multiple of any block size
TP = (0.0, 30.0, 60.0, 90.0, 120.0)


def _huge(input_dims):
    """Weights of 1e20 from ΔG through to the head: a rising glucose curve
    drives the production, and the trajectory, past float32."""
    w1 = np.zeros((4, input_dims))
    w1[:, 0] = 1e20
    return np.concatenate([w1.ravel(), np.zeros(4), np.eye(4).ravel(),
                           np.zeros(4), np.full(4, 1e20), [0.0]])


def _lanes(input_dims, seed=3):
    """Per-lane cohort, weights and β; the last lane's weights are huge, so
    its SSE is inf."""
    rng = np.random.default_rng(seed)
    jnet = jax_chain(4, 2, "tanh", input_dims=input_dims)
    glucose = 5.0 + rng.uniform(0, 5, (LANES, 5))
    glucose[-1] = [5.0, 6.0, 7.0, 8.0, 9.0]
    raw = (glucose, np.asarray(TP),
           0.5 + rng.uniform(0, 1.5, (LANES, 5)), rng.uniform(30, 70, LANES),
           rng.uniform(size=LANES) > 0.5)
    jc = jcp.build_cohort(*raw)
    nn = np.array(jnet.init_batch(jax.random.key(seed), LANES))
    nn[-1] = _huge(input_dims)
    betas = rng.uniform(-3.0, 0.5, LANES).astype(np.float32)
    kin = np.array(cohort_kinetics(jc, with_age=input_dims == 3))
    return jnet, jc, nn, betas, kin


def _port(input_dims, nn, betas, jc, kin):
    net = chain(4, 2, input_dims=input_dims)
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    return rk4_cohort.cohort_sse(net, t(nn), t(betas), t(jc.individuals.glucose),
                                 t(jc.cpeptide), t(kin), TP, 8).numpy()


@pytest.mark.parametrize("input_dims", [2, 3])
def test_plain_matches_pallas_interpret(input_dims):
    jnet, jc, nn, betas, kin = _lanes(input_dims)
    before = rk4_cohort.launches
    out = _port(input_dims, nn, betas, jc, kin)
    assert rk4_cohort.launches == before        # the CPU path launches nothing
    ref = np.asarray(cohort_sse_pallas(
        jnet, jnp.asarray(nn), jnp.asarray(betas), jc.individuals.glucose,
        jc.cpeptide, jnp.asarray(kin), TP, 8, interpret=True))
    assert np.isinf(out[-1]) and np.isinf(ref[-1])
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[:-1], ref[:-1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("input_dims", [2, 3])
def test_plain_matches_xla_rk4(input_dims):
    jnet, jc, nn, betas, kin = _lanes(input_dims, seed=5)
    kind = "conditional" if input_dims == 2 else "conditional_covariate"
    jmodel = jcp.CPeptideModel(kind=kind, net=jnet)
    out = _port(input_dims, nn, betas, jc, kin)
    ref = np.asarray(jax.vmap(lambda n, b, ind, d: jax_sse(
        jmodel, {"neural": n, "conditional": b}, ind, jc.timepoints, d,
        solver="rk4", substeps=8))(jnp.asarray(nn), jnp.asarray(betas),
                                   jc.individuals, jc.cpeptide))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out[:-1], ref[:-1], rtol=RTOL, atol=ATOL)


def test_shared_weight_row_is_a_stride0_view():
    _, jc, nn, betas, kin = _lanes(2)
    net = chain(4, 2)
    t = lambda a: torch.as_tensor(np.array(a, np.float32))  # noqa: E731
    shared = t(nn[0]).expand(LANES, -1)
    assert shared.stride(0) == 0
    out = rk4_cohort.cohort_sse(net, shared, t(betas),
                                t(jc.individuals.glucose), t(jc.cpeptide),
                                t(kin), TP, 8)
    dense = rk4_cohort.cohort_sse(net, shared.contiguous(), t(betas),
                                  t(jc.individuals.glucose), t(jc.cpeptide),
                                  t(kin), TP, 8)
    torch.testing.assert_close(out, dense, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    net = chain(4, 2)
    L = 4
    ok = dict(nn_params=torch.zeros(L, 37), betas=torch.zeros(L),
              glucose=torch.ones(L, 5), data=torch.ones(L, 5),
              kinetics=torch.ones(L, 4))

    def call(net_=net, tp=TP, **kw):
        args = {**ok, **kw}
        return rk4_cohort.cohort_sse(net_, args["nn_params"], args["betas"],
                                     args["glucose"], args["data"],
                                     args["kinetics"], tp, 8)

    assert call().shape == (L,)
    with pytest.raises(ValueError):
        call(glucose=torch.ones(L, 4))
    with pytest.raises(ValueError):
        call(kinetics=torch.ones(L, 5))       # 5 columns need a 3-input net
    with pytest.raises(TypeError):
        call(betas=torch.zeros(L, dtype=torch.float64))
    with pytest.raises(ValueError):
        call(tp=(0.0, 60.0, 30.0, 90.0, 120.0))
    for bad in (chain(4, 2, "relu"),
                chain(4, 2, output_activation="identity")):
        with pytest.raises(ValueError):
            call(net_=bad, nn_params=torch.zeros(L, bad.num_params))
    # the JAX kernels take any widths and depth of tanh layers, so do these
    for wide in (chain(8, 2), chain(4, 3)):
        assert call(net_=wide,
                    nn_params=torch.zeros(L, wide.num_params)).shape == (L,)
        with pytest.raises(ValueError):       # P must match the network
            call(net_=wide, nn_params=torch.zeros(L, wide.num_params - 1))


def test_segment_constants():
    segs, j0, one_minus_w0, w0 = rk4_cohort._segments(TP, 8)
    np.testing.assert_array_equal(
        segs[0], np.float32([0.0, 3.75, 1.875, 0.625, 1.0 / 30.0]))
    assert segs.shape == (4, 5) and (j0, one_minus_w0, w0) == (0, 1.0, 0.0)
    # a grid that starts before 0: ΔG is measured from the t = 0 blend
    segs, j0, one_minus_w0, w0 = rk4_cohort._segments((-10.0, 5.0, 30.0), 4)
    assert (j0, w0) == (0, 10.0 / 15.0)
    assert one_minus_w0 == np.float32(1.0 - 10.0 / 15.0)


def test_build_command_targets_hopper_without_fast_math():
    """Every kernel of the port builds with the same flags, from its own
    source, into a library named by the source, the headers and the flags."""
    from conditional_ude_tpu_torch.ops import (
        cuda_build,
        lane_grad,
        population_grad,
        rk4_population,
        tsit5_cohort,
    )

    mods = (rk4_cohort, rk4_population, lane_grad, tsit5_cohort,
            population_grad)
    assert len({m.kernel.source for m in mods}) == 5
    for mod in mods:
        src = mod.kernel.source
        assert mod.kernel_age.source == src
        cmd = cuda_build.nvcc_command(src, cuda_build.BUILD_DIR / "x.so")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd and "-shared" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
        assert cmd[-1] == str(src) and src.exists()
        lib = cuda_build.library_path(src)
        assert lib.parent == cuda_build.BUILD_DIR
        assert lib.name.startswith(src.stem + "-")

