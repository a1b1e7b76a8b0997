"""Device meshes over the restart and individual axes (counterpart of
``conditional_ude_tpu/parallel``); ``python -m
conditional_ude_tpu_torch.parallel`` runs :func:`dryrun.dryrun_mesh`."""

from conditional_ude_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedCohort,
    gather,
    make_mesh,
    pad_cohort,
    pad_to_multiple,
    replicate,
    shard_cohort,
    shard_leading,
    sharded_beta_profiles,
    sharded_fit_betas,
    sharded_screen,
    sharded_screen_tsit5,
)

__all__ = [
    "Mesh",
    "ShardedCohort",
    "gather",
    "make_mesh",
    "pad_cohort",
    "pad_to_multiple",
    "replicate",
    "shard_cohort",
    "shard_leading",
    "sharded_beta_profiles",
    "sharded_fit_betas",
    "sharded_screen",
    "sharded_screen_tsit5",
]
