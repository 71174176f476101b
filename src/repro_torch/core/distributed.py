"""The ensemble entry point: advance a batch of independent lanes.

Only the single-device branch (``mesh=None``) is ported; the sharded
halo-exchange stepper is ROADMAP item 5.
"""
from __future__ import annotations

from repro_torch.kernels.fhp_step import ops


def make_ensemble_run(mesh, steps: int, *, variant: str = "fhp2",
                      p_force: float = 0.0,
                      steps_per_launch: int | None = None,
                      block_rows: int = 0, block_words: int = 0,
                      moments_every: int = 0):
    """``(run, None)`` for a batched ``(B, n_planes, H, Wd)`` ensemble: the
    serve engine's one entry point for advancing a lane group.

    ``run(planes, t0)`` advances every lane ``steps`` steps under
    ``variant`` through ``ops.run_cuda``: on a CUDA tensor the fused
    kernel, on a CPU tensor its plain version.  Lanes are independent and
    the RNG counters carry no lane index, so each lane is bit-identical to
    the unbatched reference at the same ``t`` window.

    ``moments_every`` = k > 0 makes ``run`` return ``(planes, moments)``
    with ``moments`` the per-lane ``(B, steps // k, n_moments)`` int32
    ``MomentSpec`` time series (``rulespec.moment_spec(rule)``)."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded (mesh) ensemble path is not ported yet: see "
            "ROADMAP.md, 'Modules to port', item 5")

    def run(planes, t0: int = 0):
        return ops.run_cuda(planes, steps, p_force=p_force, t0=t0,
                            steps_per_launch=steps_per_launch or 1,
                            block_rows=block_rows, block_words=block_words,
                            variant=variant, moments_every=moments_every)

    return run, None
