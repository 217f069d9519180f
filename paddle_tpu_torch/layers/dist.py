"""Sharding-annotation surface for multi-device SPMD programs.

Counterpart of paddle_tpu/layers/dist.py.  Users annotate a few
tensors with per-dim mesh-axis names; the spmd propagation
(parallel/spmd.py) completes the rest, and ParallelExecutor places the
parameters and inserts the collectives.  These helpers only record
annotations on the Program IR — they are inert under the serial
Executor, so one Program trains serially and on a mesh.  The
`sharding-consistency` analysis pass lints the annotations at build
time.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core.framework import (Variable, default_main_program,
                              normalize_sharding)

__all__ = ["shard", "set_program_mesh"]


def shard(x, spec, main_program=None):
    """Annotate variable `x` (a Variable or its name) with sharding
    `spec` and return the variable.

    `spec`: one entry per tensor dim — a mesh-axis name, a tuple of
    axis names (dim split over their product), or None (replicated),
    e.g. `shard(h, (None, "tp"))` marks activation `h`'s feature dim
    tensor-split.  Annotating a weight directly
    (`shard("fc_0.w_0", (None, "tp"))`) works too; the spmd
    propagation otherwise derives weight splits from activation
    annotations by the Megatron column/row alternation rule.

    A second annotation on the same var must agree with the first —
    contradictory specs raise here (and are also caught program-wide by
    the sharding-consistency pass for specs that arrive via
    deserialization)."""
    prog = main_program or default_main_program()
    if isinstance(x, Variable):
        v = x
    else:
        v = prog.current_block.var(str(x))
    spec = normalize_sharding(spec)
    if v.sharding is not None and v.sharding != spec:
        raise ValueError(
            f"variable {v.name!r} is already annotated with sharding "
            f"{v.sharding}; refusing the contradictory {spec}")
    v.sharding = spec
    # mirror the annotation on the producing op desc so transpiled /
    # serialized programs carry it op-side as well
    if v.op is not None:
        sh = dict(v.op.dist_attr.get("sharding", {}))
        sh[v.name] = [list(e) if isinstance(e, tuple) else e
                      for e in spec] if spec is not None else None
        v.op.set_dist_attr("sharding", sh)
    # unconditional: params/feeds have no producing op, but the
    # annotation still changes to_dict()/verification results, so
    # version-keyed caches (preflight, fingerprints) must miss
    v.block.program.bump_version()
    return v


def set_program_mesh(axes: Optional[Dict[str, int]], main_program=None):
    """Declare the device-mesh axes ({name: size}) the program's
    sharding annotations refer to.  Optional — the transpiler records
    the mesh it is given — but declaring it up front lets the
    sharding-consistency pass validate axis names and divisibility at
    build time, before any mesh exists."""
    prog = main_program or default_main_program()
    prog.mesh_axes = (None if axes is None
                      else {str(k): int(v) for k, v in axes.items()})
    prog.bump_version()
    return prog.mesh_axes
