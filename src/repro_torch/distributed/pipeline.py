"""GPipe-style pipeline parallelism over a mesh axis: the JAX package's
``src/repro/distributed/pipeline.py``, with each rank of the axis one
stage and a ring of point-to-point sends (``batch_isend_irecv``) where the
reference ``ppermute``s.

Each rank of the axis holds a contiguous stage of layers; activations flow
stage to stage (the inter-pod analogue of the paper's point-to-point
cascade — neighbour-only, FIFO-ordered), microbatches fill and drain
GPipe-style.

Schedule (the reference's), n_stages=4, n_micro=6:

    stage0: m0 m1 m2 m3 m4 m5 .  .  .
    stage1: .  m0 m1 m2 m3 m4 m5 .  .
    stage2: .  .  m0 m1 m2 m3 m4 m5 .
    stage3: .  .  .  m0 m1 m2 m3 m4 m5

Bubble fraction = (n_stages-1)/(n_micro+n_stages-1).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack per-stage param trees on a new leading axis (one row a
    stage)."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def _stage_row(a, stage: int):
    """This stage's row of a stacked leaf: a DTensor sharded over the axis
    holds it locally as (1, ...); a plain tensor holds every row."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        return a.to_local()[0]
    return a[stage]


def pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
             mesh, axis: str, n_micro: int,
             ) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Build a pipelined forward: (stacked_params, x) -> y, run by every
    rank of ``mesh`` (a ``DeviceMesh``) on the same x.

    ``stage_fn(stage_params, x_mb) -> y_mb`` is one stage's computation on
    one microbatch; input/output shapes must match (residual-block stacks).
    ``stacked_params`` leaves carry a leading n_stages dim (stage i's row on
    the axis's rank i). x: (batch, ...) with batch divisible by n_micro. Every
    rank returns the last stage's output.
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    def shift(y: torch.Tensor) -> torch.Tensor:
        """The ring step: send y to the next stage, take the previous's."""
        if n_stages == 1:
            return y
        buf = torch.empty_like(y)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)]):
            r.wait()
        return buf

    def run(stacked_params, x):
        B = x.shape[0]
        assert B % n_micro == 0, (B, n_micro)
        xm = x.reshape(n_micro, B // n_micro, *x.shape[1:])
        p_local = tree_map(lambda a: _stage_row(a, stage), stacked_params)
        buf = torch.zeros_like(xm[0])
        outs = torch.zeros_like(xm)
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t (the buffer once the input drains)
            x_in = xm[t] if (stage == 0 and t < n_micro) else buf
            y = stage_fn(p_local, x_in)
            # the last stage collects microbatch t-(n_stages-1)
            if stage == n_stages - 1 and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = y
            buf = shift(y)
        # only the last stage holds real data (the others kept zeros); a sum
        # over the axis hands it to every stage
        if n_stages > 1:
            dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs.reshape(B, *x.shape[1:])

    return run


def pipeline_with_broadcast(stage_fn, mesh, axis: str, n_micro: int):
    """Like :func:`pipeline` (whose final sum already hands the last
    stage's output to every stage), as the reference's."""
    base = pipeline(stage_fn, mesh, axis, n_micro)

    def run(stacked_params, x):
        return base(stacked_params, x)

    return run


__all__ = ["stack_stage_params", "pipeline", "pipeline_with_broadcast"]
