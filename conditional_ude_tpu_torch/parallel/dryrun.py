"""A tiny run of every sharded subsystem on a mesh (counterpart of
``__graft_entry__.py::dryrun_multichip``, ``:68-285``).

:func:`dryrun_mesh` runs, at tiny shapes: joint training on a 2-D
``("restarts", "individuals")`` mesh and on the 1-D ``("restarts",)`` mesh
with the pad path and the Tsit5 re-rank, the K1 screen, the K4 census over
the individuals, the suppression λ sweep over the restarts, and SAEM over
an individual-sharded cohort, held to the unsharded run (``nll_trace``
within atol 1e-4, as JAX's dry run holds it).  ``python -m
conditional_ude_tpu_torch.parallel`` runs it on every card, or on a 2-way
mesh of ``cuda:0`` when there is one card.
"""

from __future__ import annotations

import numpy as np
import torch

from conditional_ude_tpu_torch.analysis.profiles import Profile
from conditional_ude_tpu_torch.fit.saem import SAEMConfig, saem_cude
from conditional_ude_tpu_torch.fit.train import TrainConfig, train_conditional
from conditional_ude_tpu_torch.models import suppression as sup
from conditional_ude_tpu_torch.models.cpeptide import (
    Cohort,
    CPeptideModel,
    build_cohort,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_cohort,
    sharded_beta_profiles,
    sharded_screen,
)


def synthetic_cohort(n: int, device, seed: int = 0) -> Cohort:
    """A small OGTT-like cohort (``__graft_entry__.py::_synthetic_cohort``'s
    construction)."""
    rng = np.random.default_rng(seed)
    tp = np.array([0.0, 30.0, 60.0, 90.0, 120.0], np.float32)
    base_g = np.array([5.0, 8.5, 9.5, 8.0, 6.5], np.float32)
    base_c = np.array([0.6, 1.4, 1.9, 1.7, 1.3], np.float32)
    glucose = base_g * (1.0 + 0.1 * rng.standard_normal((n, 5))).astype(
        np.float32)
    cpeptide = base_c * (1.0 + 0.1 * rng.standard_normal((n, 5))).astype(
        np.float32)
    ages = rng.uniform(30, 70, n).astype(np.float32)
    return build_cohort(np.abs(glucose), tp, np.abs(cpeptide), ages,
                        np.arange(n) % 3 == 0, device)


def dryrun_mesh(devices=None) -> dict:
    """Every sharded subsystem once on a mesh of ``devices`` (default:
    every card, or ``cuda:0`` twice on one card); raises on any failure.
    Returns ``{"devices": n, "exercised": [...]}``."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("dryrun_mesh found no CUDA card; give the "
                               "devices, e.g. ['cpu'] * 2")
        devices = ([torch.device("cuda", i) for i in range(count)]
                   if count > 1 else [torch.device("cuda", 0)] * 2)
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    first = devices[0]
    shape = (n_dev // 2, 2) if n_dev >= 4 and n_dev % 2 == 0 else (n_dev, 1)
    model = CPeptideModel(chain(4, 2))
    done = []

    # joint training on the 2-D mesh: restart shards on each row's first
    # device, the individuals whole on each (the Tsit5 re-rank runs below)
    mesh2 = make_mesh(("restarts", "individuals"), shape, devices)
    n_ind = 4 * shape[1]
    cohort = synthetic_cohort(n_ind, first)
    res = train_conditional(model, cohort, TrainConfig(
        initial_guesses=4 * shape[0], selected_initials=shape[0],
        adam_iters=2, lbfgs_iters=2, screen_chunk=4 * shape[0],
        final_eval_tsit5=False), seed=1, mesh=mesh2)
    assert res.nn_params.shape[0] == shape[0], res.nn_params.shape
    assert res.betas.shape == (shape[0], n_ind, 1), res.betas.shape
    done.append("train_2d")

    # the 1-D restart mesh with one restart more than the rows (the pad
    # path), 2 substeps and the Tsit5 re-rank
    mesh_r = make_mesh(("restarts",), (n_dev,), devices)
    fused = train_conditional(model, cohort, TrainConfig(
        initial_guesses=2 * n_dev, selected_initials=shape[0] + 1,
        adam_iters=2, lbfgs_iters=2, substeps=2, max_steps=64,
        screen_chunk=2 * n_dev), seed=4, mesh=mesh_r)
    assert fused.nn_params.shape[0] == shape[0] + 1
    assert bool(torch.isfinite(fused.objectives).any())
    done.append("train_fused_pad")

    # the K1 screen over the restart shards of the 2-D mesh
    g = 2 * shape[0]
    nn = model.net.init_batch(g, torch.Generator(first).manual_seed(2))
    betas = torch.full((g, n_ind), -1.0, device=first)
    screen = sharded_screen(model.net, nn, betas, cohort, mesh2)
    assert screen.shape == (g,)
    done.append("screen")

    # the K4 census over the individuals of a 1-D mesh
    mesh_i = make_mesh(("individuals",), (n_dev,), devices)
    prof = sharded_beta_profiles(model, nn[0], cohort, mesh_i, lower=-2.0,
                                 upper=0.0, steps=8, chunk=8, substeps=2,
                                 require_kernel=True)
    assert isinstance(prof, Profile) and prof.values.shape == (n_ind, 8)
    done.append("census")

    # the suppression λ sweep over the restarts
    tp = np.linspace(0.0, 30.0, 5)
    data, _ = sup.generate_data([0.5, 5.0], [2, 2], tp,
                                noise_multiplicative=0.05,
                                rng=np.random.default_rng(0))
    net = sup.suppression_net(depth=3, width=3)
    fit = sup.fit_suppression_sweep(
        net, data, tp, [0.0, 0.1], sup.SuppressionFitConfig(
            initial_space=2 * n_dev, select_best_n=2, adam_iters=2,
            lbfgs_iters=2, screen_chunk=2 * n_dev), device=first,
        generator=torch.Generator().manual_seed(3), mesh=mesh_r)
    assert fit.objectives.shape == (2, 2)
    done.append("suppression")

    # SAEM over an individual-sharded cohort, held to the unsharded run
    cfg = SAEMConfig(iterations=3, burnin=1, n_mcmc_steps=2)
    nn0 = model.net.init_batch(1, torch.Generator(first).manual_seed(5))[0]
    saem_cohort = synthetic_cohort(2 * n_dev, first, seed=7)
    plain = saem_cude(model, saem_cohort, nn0,
                      torch.Generator(first).manual_seed(6), cfg)
    sharded = saem_cude(model, shard_cohort(saem_cohort, mesh_i), nn0,
                        torch.Generator(first).manual_seed(6), cfg)
    np.testing.assert_allclose(sharded.nll_trace.cpu().numpy(),
                               plain.nll_trace.cpu().numpy(), atol=1e-4)
    done.append("saem")
    return {"devices": n_dev, "mesh_2d": list(shape), "exercised": done}
