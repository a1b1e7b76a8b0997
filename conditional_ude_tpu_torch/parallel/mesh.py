"""Device meshes for the two parallel axes, restarts and individuals
(counterpart of ``conditional_ude_tpu/parallel/mesh.py``).

The JAX package lays these axes over a ``jax.sharding.Mesh`` and lets XLA
partition its vmapped programs.  Here a mesh is a grid of ``torch.device``s
in one process, with no collective of its own: a sharded evaluation splits
its rows (restarts, lanes or individuals) over the devices of one axis,
launches every shard's kernel before it waits on any, and concatenates the
results in shard order onto the mesh's first device (:func:`gather`).  The
optimizers (Adam, L-BFGS) keep their state on that device, as unsharded,
so a row's trajectory depends on its own evaluations alone and padded rows
cannot leak into real ones.  A device may repeat: ``[cuda:0, cuda:0]`` is a
2-way mesh on one card, which exercises the split, the padding and the
gather (not a speedup).

* :func:`make_mesh`, :func:`pad_to_multiple`, :func:`pad_cohort`,
  :func:`shard_leading`, :func:`replicate`, :func:`shard_cohort` and
  :func:`gather`: the mesh and its helpers.  A :class:`ShardedCohort` is
  accepted wherever the JAX package accepts a cohort sharded over
  individuals: the losses (``fit/losses.py``), the frozen-network fits
  (``fit/train.py::fit_betas``) and SAEM's likelihood
  (``fit/saem.py::CohortLogLik``).
* :func:`sharded_screen` (K1), :func:`sharded_screen_tsit5` (K3) and
  :func:`sharded_population_vg` (K2, or K5 past ``PACK_MAX_LANES`` lanes of
  a shard) over the restart axis, which ``train_conditional(mesh=...)``
  runs.
* :func:`sharded_fit_betas` and :func:`sharded_beta_profiles` (K4, K4c)
  over the individual axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np
import torch

from conditional_ude_tpu_torch.models.cpeptide import Cohort
from conditional_ude_tpu_torch.ops import (
    lane_grad,
    rk4_population,
    tsit5_cohort,
)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``, an object array of ``torch.device`` whose axes are
    named by ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along ``axis_name``, at index 0 of every other axis
        (a restart shard of a 2-D mesh runs on the first device of its
        row)."""
        if axis_name not in self.axis_names:
            raise ValueError(f"the mesh has no axis {axis_name!r}: "
                             f"{self.axis_names}")
        ax = self.axis_names.index(axis_name)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            idx[ax] = i
            out.append(self.devices[tuple(idx)])
        return out


def make_mesh(axis_names: Sequence[str] = ("restarts",),
              shape: Sequence[int] | None = None,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA card; none raises).

    With ``shape=None`` the first axis takes every device and the others
    get size 1.  ``ValueError`` when ``prod(shape)`` is not the device
    count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh found no CUDA card; give the "
                               "devices, e.g. devices=['cpu'] * 2")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} does not name its axes "
                         f"{tuple(axis_names)}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), tuple(axis_names))


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0,
                    fill=None) -> torch.Tensor:
    """``x`` with ``axis`` padded up to a multiple of ``multiple``: the new
    entries repeat the last real one (``fill=None``; they behave like a
    real row and the caller slices them off) or are ``fill``."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    shape = list(x.shape)
    shape[axis] = target - n
    if fill is None:
        tail = x.narrow(axis, n - 1, 1).expand(shape)
    else:
        tail = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=axis)


def _row_fields(cohort: Cohort) -> list[str]:
    """The cohort's fields with a leading individual axis."""
    return [f.name for f in dataclasses.fields(cohort)
            if f.name != "timepoints" and getattr(cohort, f.name) is not None]


def pad_cohort(cohort: Cohort, multiple: int) -> Cohort:
    """``cohort`` padded to a multiple of ``multiple`` individuals, the
    last one repeated; callers slice their results back to the true n."""
    if cohort.n % multiple == 0:
        return cohort
    return dataclasses.replace(cohort, **{
        f: pad_to_multiple(getattr(cohort, f), multiple)
        for f in _row_fields(cohort)})


def gather(parts: Sequence[torch.Tensor], device: torch.device,
           dim: int = 0) -> torch.Tensor:
    """The shards' results concatenated in shard order on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _part(x: torch.Tensor, devices: Sequence[torch.device], i: int,
          dim: int = 0) -> torch.Tensor:
    """The i-th of equal parts of ``x`` along ``dim``, on ``devices[i]``."""
    size = x.shape[dim]
    if size % len(devices):
        raise ValueError(f"{size} rows do not divide over {len(devices)} "
                         "shards (pad_to_multiple first)")
    step = size // len(devices)
    return x.narrow(dim, i * step, step).to(devices[i])


def split(x: torch.Tensor, devices: Sequence[torch.device],
          dim: int = 0) -> list[torch.Tensor]:
    """Equal parts of ``x`` along ``dim``, one on each device."""
    return [_part(x, devices, i, dim) for i in range(len(devices))]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_leading(tree: Any, mesh: Mesh, axis_name: str = "restarts") -> list:
    """Every tensor of ``tree`` (a tensor, or tuples, lists and dicts of
    them) split along its leading axis over ``axis_name``: one tree a
    device, in mesh order.  Leading sizes must divide the axis
    (:func:`pad_to_multiple` first); 0-d tensors are copied to every
    device."""
    devices = mesh.axis_devices(axis_name)

    def shard(i):
        def one(x):
            x = torch.as_tensor(x)
            return x.to(devices[i]) if x.ndim == 0 else _part(x, devices, i)
        return one

    return [_tree_map(shard(i), tree) for i in range(len(devices))]


def replicate(tree: Any, mesh: Mesh, axis_name: str | None = None) -> list:
    """One copy of ``tree`` on every device along ``axis_name`` (on every
    device of the mesh when None), in mesh order."""
    devices = (list(mesh.devices.flat) if axis_name is None
               else mesh.axis_devices(axis_name))
    return [_tree_map(lambda x: torch.as_tensor(x).to(d), tree)
            for d in devices]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCohort:
    """A cohort split over the individuals: ``shards[k]`` lives on the k-th
    device along ``axis_name``; ``n`` individuals in all."""

    shards: tuple[Cohort, ...]
    mesh: Mesh
    n: int
    axis_name: str = "individuals"

    @property
    def device(self) -> torch.device:
        """Where results are gathered (the first shard's device)."""
        return self.shards[0].device

    @property
    def timepoints(self) -> np.ndarray:
        return self.shards[0].timepoints

    def whole(self) -> Cohort:
        """The cohort gathered onto :attr:`device`."""
        first = self.shards[0]
        return dataclasses.replace(first, **{
            f: gather([getattr(s, f) for s in self.shards], self.device)
            for f in _row_fields(first)})

    def split(self, x: torch.Tensor, dim: int = -1) -> list[torch.Tensor]:
        """``x`` split along its individual axis ``dim`` as the individuals
        are, one part on each shard's device."""
        parts = torch.split(x, [s.n for s in self.shards], dim)
        return [p.to(s.device) for p, s in zip(parts, self.shards)]

    def map(self, fn: Callable, lanes: torch.Tensor,
            nn_params: torch.Tensor | None = None) -> torch.Tensor:
        """``fn(shard, lanes_k, nn_params)`` on every shard, its lanes
        ``[..., N]`` split on the last axis and ``nn_params`` (shared by the
        individuals) copied to its device; gathered on the last axis."""
        outs = [fn(s, b, None if nn_params is None
                   else nn_params.to(s.device))
                for s, b in zip(self.shards, self.split(lanes, -1))]
        return gather(outs, self.device, dim=-1)


def shard_cohort(cohort: Cohort, mesh: Mesh,
                 axis_name: str = "individuals") -> ShardedCohort:
    """``cohort`` split over ``axis_name``: every per-individual tensor
    splits on its leading axis, the time grid is shared.  Where the
    individuals do not divide the axis the first shards take one more
    (a padded subject would enter SAEM's sums; JAX needs
    :func:`pad_cohort` first, and the fits and profiles here pad as its
    do)."""
    devices = mesh.axis_devices(axis_name)
    if cohort.n < len(devices):
        raise ValueError(f"{cohort.n} individuals cannot fill "
                         f"{len(devices)} shards")
    sizes = [len(a) for a in np.array_split(np.arange(cohort.n),
                                            len(devices))]
    fields = _row_fields(cohort)
    parts = {f: torch.split(getattr(cohort, f), sizes) for f in fields}
    shards = tuple(dataclasses.replace(cohort, **{f: parts[f][i].to(d)
                                                  for f in fields})
                   for i, d in enumerate(devices))
    return ShardedCohort(shards, mesh, cohort.n, axis_name)


def cohort_args(cohort: Cohort, with_age: bool,
                device: torch.device | None = None) -> tuple:
    """The restart kernels' cohort arguments (glucose, data, kinetics, the
    time grid), on ``device``."""
    dev = device or cohort.device
    return (cohort.glucose.to(dev), cohort.cpeptide.to(dev),
            cohort.kinetics(with_age=with_age).to(dev),
            tuple(float(t) for t in cohort.timepoints))


def _restart_shards(mesh: Mesh, axis_name: str, cohort: Cohort, with_age):
    """(devices along the axis, the whole cohort's kernel arguments on
    each)."""
    devices = mesh.axis_devices(axis_name)
    return devices, [cohort_args(cohort, with_age, d) for d in devices]


def sharded_screen(net, nn_inits: torch.Tensor, betas: torch.Tensor,
                   cohort: Cohort, mesh: Mesh, axis_name: str = "restarts",
                   substeps: int = 8, chunk: int | None = None
                   ) -> torch.Tensor:
    """K1 on each restart shard of ``nn_inits[G, P]``, ``betas[G, N]``
    with the whole cohort on every device: ``[G]`` on the mesh's first
    device (``sharded_screen_pallas``, ``mesh.py:102-138``).  G must divide
    the axis.  ``chunk`` bounds the designs of one evaluation of K1's plain
    version (CPU tensors)."""
    devices, args = _restart_shards(mesh, axis_name, cohort,
                                    net.input_dims == 3)
    nn_parts = split(nn_inits.contiguous(), devices)
    b_parts = split(betas.contiguous(), devices)
    outs = []
    for nn, b, a in zip(nn_parts, b_parts, args):
        step = nn.shape[0] if chunk is None else max(1, chunk)
        outs.append(torch.cat([
            rk4_population.population_sse(net, nn[i:i + step].contiguous(),
                                          b[i:i + step].contiguous(), *a,
                                          substeps)
            for i in range(0, nn.shape[0], step)]))
    return gather(outs, devices[0])


def sharded_screen_tsit5(net, nn_params: torch.Tensor, betas: torch.Tensor,
                         cohort: Cohort, mesh: Mesh,
                         axis_name: str = "restarts",
                         max_steps: int = 256) -> torch.Tensor:
    """K3 on each restart shard: each device expands its own restarts to
    (restart × individual) lanes and returns the mean over individuals per
    restart; ``[G]`` on the first device (``sharded_screen_tsit5_pallas``,
    ``mesh.py:141-181``)."""
    devices, args = _restart_shards(mesh, axis_name, cohort,
                                    net.input_dims == 3)
    outs = [tsit5_cohort.screen_population_tsit5(net, nn, b, *a,
                                                 max_steps=max_steps)
            for nn, b, a in zip(split(nn_params, devices),
                                split(betas, devices), args)]
    return gather(outs, devices[0])


def sharded_population_vg(net, args: tuple, mesh: Mesh,
                          axis_name: str = "restarts", substeps: int = 8):
    """``(nn[R, P], β[R, N]) -> (f[R], ∇nn[R, P], ∇β[R, N])`` with the
    restarts split over ``axis_name``, for ``ops.lane_grad.PopulationSSE``.
    ``args`` are the kernels' cohort arguments (:func:`cohort_args`), copied
    to every device of the axis.  Each shard takes K2 or K5 by its own lane
    count, as the JAX package's ``shard_map`` body sees only its block."""
    devices = mesh.axis_devices(axis_name)
    glucose, data, kinetics, timepoints = args
    per = [(glucose.to(d), data.to(d), kinetics.to(d), timepoints)
           for d in devices]

    def vg(nn: torch.Tensor, betas: torch.Tensor):
        outs = [lane_grad.population_sse_and_grad(net, nn_k, b_k, *a,
                                                  substeps)
                for nn_k, b_k, a in zip(split(nn, devices),
                                        split(betas, devices), per)]
        return tuple(gather([o[i] for o in outs], nn.device)
                     for i in range(3))

    return vg


def shard_value_and_grad(funs: Sequence[Callable], x0: Sequence[torch.Tensor],
                         devices: Sequence[torch.device],
                         capture: Callable):
    """``x -> (f[R], grads)`` for tensors ``x`` whose rows split evenly
    over ``devices``: shard k's rows go to ``funs[k]``, whose value+grad is
    ``capture(funs[k], x0_k)`` (e.g. ``fit.optim.graphed_vg``, one CUDA
    graph a shard), and the results gather in order on ``x``'s device."""
    parts0 = [split(a, devices) for a in x0]
    vgs = [capture(fun, tuple(p[k] for p in parts0))
           for k, fun in enumerate(funs)]

    def vg(x):
        parts = [split(a, devices) for a in x]
        outs = [vg_k(tuple(p[k] for p in parts)) for k, vg_k in enumerate(vgs)]
        dev = x[0].device
        return (gather([o[0] for o in outs], dev),
                tuple(gather([o[1][i] for o in outs], dev)
                      for i in range(len(x))))

    return vg


def shard_value(funs: Sequence[Callable], devices: Sequence[torch.device]):
    """``x -> f[R]`` (no gradient) with the rows of the tensors ``x``
    split as :func:`shard_value_and_grad` splits them."""
    def value(x):
        parts = [split(a, devices) for a in x]
        with torch.no_grad():
            outs = [fun(tuple(p[k] for p in parts))
                    for k, fun in enumerate(funs)]
        return gather(outs, x[0].device)
    return value


def sharded_fit_betas(model, nn_params: torch.Tensor, cohort: Cohort,
                      mesh: Mesh, axis_name: str = "individuals",
                      sigma: bool = False, **kwargs):
    """The per-individual (β[, σ]) re-estimation with the cohort split over
    ``axis_name`` (``mesh.py:215-233``): the cohort is padded to the axis,
    the batched L-BFGS keeps its rows on the first device and each
    evaluation splits them over the shards; the result is sliced back to
    the true n.  ``sigma=True`` runs ``fit_betas_sigma``."""
    from conditional_ude_tpu_torch.fit.train import fit_betas, fit_betas_sigma

    n = cohort.n
    size = mesh.shape[axis_name]
    sharded = shard_cohort(pad_cohort(cohort, size), mesh, axis_name)
    if "initial_beta" in kwargs:
        init = torch.as_tensor(kwargs["initial_beta"], dtype=torch.float32,
                               device=sharded.device)
        init = init.expand(torch.broadcast_shapes(init.shape, (n,)))
        kwargs["initial_beta"] = pad_to_multiple(init, size, -1)
    fn = fit_betas_sigma if sigma else fit_betas
    out = fn(model, nn_params, sharded, **kwargs)
    return tuple(x[..., :n] for x in out)


def sharded_beta_profiles(model, nn_params: torch.Tensor, cohort: Cohort,
                          mesh: Mesh, axis_name: str = "individuals",
                          sigmas=1.0, center=None,
                          require_kernel: bool = False,
                          lower: float = -4.0, upper: float = 1.0,
                          steps: int = 10_000, chunk: int = 500,
                          substeps: int = 8, solver: str = "rk4"):
    """Every individual's β-profile with the individuals split over
    ``axis_name`` (``mesh.py:236-333``): the cohort, the σ's and the centres
    are padded to the axis, each shard scans the full grid in chunks of
    ``chunk`` on its device, and ``Profile(grid, values[:n], minimum)``
    is gathered on the first device.

    As ``cohort_beta_profiles``, K4 (K4c for the covariate model) runs
    where it computes the model, else the batched RK4 or Tsit5 scan;
    ``require_kernel=True`` raises ``ValueError`` for a model the kernel
    cannot compute."""
    from conditional_ude_tpu_torch.analysis.profiles import (
        Profile,
        cohort_beta_profiles,
    )

    n = cohort.n
    size = mesh.shape[axis_name]
    f32 = dict(dtype=torch.float32, device=cohort.device)
    sig = pad_to_multiple(torch.as_tensor(sigmas, **f32).expand(n), size)
    ctr = pad_to_multiple(torch.zeros(n, **f32) if center is None
                          else torch.as_tensor(center, **f32), size)
    sharded = shard_cohort(pad_cohort(cohort, size), mesh, axis_name)
    profs = [cohort_beta_profiles(model, nn_params.to(c.device), c,
                                  sigmas=s, lower=lower, upper=upper,
                                  steps=steps, chunk=chunk, center=m,
                                  substeps=substeps, solver=solver,
                                  require_kernel=require_kernel)
             for c, s, m in zip(sharded.shards, sharded.split(sig, 0),
                                sharded.split(ctr, 0))]
    values = gather([p.values for p in profs], sharded.device)[:n]
    return Profile(grid=profs[0].grid, values=values,
                   minimum=values.amin(1))
