"""GPipe-style pipeline parallelism with point-to-point sends.

At >512-card scale (or >400B params) DP×TP alone stops fitting; this module
provides the PP axis: layers are striped across a ``stage`` mesh axis and
microbatches stream through with point-to-point transfers
(``dist.batch_isend_irecv``) — no all-gathers on the critical path.

Schedule (standard GPipe, M microbatches over P stages):

  for t in 0 .. M+P-2:          # pipeline ticks
      every stage: if it holds a live microbatch (0 <= t - stage < M), run
      its layer slice
      send activations stage i -> i+1

Bubble fraction = (P-1)/(M+P-1).  The output reaches every rank: the last
stage's outputs, the others' zeros, summed over the stage group (the
reference's masked ``psum``).

Autograd does not cross a send, so :class:`_GPipe` carries the backward
schedule itself: the ticks in reverse, each live stage recomputing its
forward for the microbatch from the input it saved, taking the
vector-Jacobian product and sending the input's gradient to stage i-1.  The
output is replicated, so every rank computes the same loss from it; the
backward reads the last stage's gradient of it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

__all__ = ["pipelined_apply", "make_pp_train_step"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], it) for key in sorted(tree)}
    return next(it)


def _exchange(sends: list, recvs: list) -> None:
    """``sends``: ``[(tensor, peer)]``, ``recvs``: ``[(buffer, peer)]``."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), peer) for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer) for buf, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, tree, group, x, *leaves):
        P = dist.get_world_size(group)
        idx = dist.get_rank(group)
        peer = [dist.get_global_rank(group, i) for i in range(P)]
        M = x.shape[0]
        params = _rebuild(tree, iter(leaves))
        # NCCL: a group's first batched send / receive must include every rank, and the
        # first tick's involves two; an all-rank collective goes first
        dist.all_reduce(torch.zeros(1, device=x.device), group=group)
        state = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        saved = {}

        def live(stage, t):
            return 0 <= t - stage < M

        for t in range(M + P - 1):
            if idx == 0 and t < M:  # stage 0 injects microbatch t
                state = x[t]
            if live(idx, t):
                saved[t - idx] = state
                state = stage_fn(params, state)
                if idx == P - 1:  # the last stage writes microbatch t - (P - 1)
                    outputs[t - idx] = state
            sends = [(state, peer[idx + 1])] if idx < P - 1 and live(idx, t) else []
            recvs = []
            if idx > 0 and live(idx - 1, t):
                state = torch.empty_like(x[0])
                recvs = [(state, peer[idx - 1])]
            _exchange(sends, recvs)
        if idx != P - 1:
            outputs.zero_()
        dist.all_reduce(outputs, group=group)
        ctx.stage_fn, ctx.tree, ctx.group = stage_fn, tree, group
        ctx.saved_inputs = saved
        ctx.save_for_backward(*leaves)
        ctx.M = M
        return outputs

    @staticmethod
    def backward(ctx, grad_out):
        group = ctx.group
        P = dist.get_world_size(group)
        idx = dist.get_rank(group)
        peer = [dist.get_global_rank(group, i) for i in range(P)]
        M = ctx.M
        leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        params = _rebuild(ctx.tree, iter(leaves))
        grads = [torch.zeros_like(t) for t in leaves]
        grad_x = torch.zeros_like(grad_out)
        g = None

        def live(stage, t):
            return 0 <= t - stage < M

        for t in range(M + P - 2, -1, -1):
            gin = None
            if live(idx, t):
                m = t - idx
                if idx == P - 1:
                    g = grad_out[m]
                inp = ctx.saved_inputs[m].detach().requires_grad_(True)
                with torch.enable_grad():
                    out = ctx.stage_fn(params, inp)
                    gin, *gp = torch.autograd.grad(out, [inp, *leaves], g, allow_unused=True)
                for acc, gl in zip(grads, gp):
                    if gl is not None:
                        acc += gl
                if idx == 0:
                    grad_x[m] = gin
            sends = [(gin, peer[idx - 1])] if idx > 0 and gin is not None else []
            recvs = []
            if idx < P - 1 and live(idx + 1, t):
                g = torch.empty_like(grad_out[0])
                recvs = [(g, peer[idx + 1])]
            _exchange(sends, recvs)
        if idx != 0:
            grad_x.zero_()
        dist.all_reduce(grad_x, group=group)
        return (None, None, None, grad_x, *grads)


def _stage_group(mesh, stage_axis: str):
    return mesh.get_group(mesh.mesh_dim_names.index(stage_axis))


def pipelined_apply(
    stage_fn: Callable,  # (stage_params, x) -> x  — one stage's layer slice
    params,  # tree with leading dim = n_stages on every leaf
    x: torch.Tensor,  # [M, mb, ...] microbatched activations, the same on every rank
    mesh,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Run x through all stages in pipeline order; every rank returns the
    whole output.  Each leaf of ``params`` is either a tensor every rank
    holds whole (this rank reads its stage's row) or a DTensor sharded
    ``Shard(0)`` over ``stage_axis`` (this rank's local row).  Differentiable
    in ``x`` and the parameters."""
    group = _stage_group(mesh, stage_axis)
    idx = dist.get_rank(group)
    leaves = []
    for leaf in _leaves(params):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
            if leaf.shape[0] != 1:
                raise ValueError(f"a DTensor leaf must hold one stage a rank, got {leaf.shape[0]}")
            leaves.append(leaf[0])
        else:
            leaves.append(leaf[idx])
    return _GPipe.apply(stage_fn, params, group, x, *leaves)


def make_pp_train_step(stage_fn, loss_fn, mesh, stage_axis: str = "stage"):
    """Toy end-to-end PP train step for the tests: forward via
    ``pipelined_apply``, loss on the full output, gradients through its
    backward schedule, an SGD update.  Plain (whole) parameter tensors get
    their stage rows' gradients summed over the stage group, so every rank
    holds the same updated parameters; DTensor ones update their shards."""
    group = _stage_group(mesh, stage_axis)

    def step(params, x, y, lr):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        tree = _rebuild(params, iter(leaves))
        loss = loss_fn(pipelined_apply(stage_fn, tree, x, mesh, stage_axis), y)
        grads = torch.autograd.grad(loss, leaves)
        new = []
        for p, g in zip(leaves, grads):
            if not isinstance(g, DTensor):
                dist.all_reduce(g, group=group)
            new.append((p - lr * g).detach())
        return _rebuild(params, iter(new)), loss.detach()

    return step
