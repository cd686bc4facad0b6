"""Collectives over the mesh's process groups, with and without gradients.

JAX's mesh programs get their collectives from GSPMD or name them inside
``shard_map`` (``psum``, ``ppermute``, ``all_gather``); the port's ranks
call them through ``torch.distributed``. Two kinds live here:

- in-place helpers the trainer calls outside autograd (``all_reduce_``,
  ``broadcast_``, ``all_gather_into``, ``reduce_scatter_into``,
  ``ring_shift``, ``barrier``);
- small ``torch.autograd.Function``s for layers whose forward mixes
  ranks. Their backward follows the convention of the port's per-rank
  programs: ranks of one ``model``, ``seq`` or ``pipe`` slice hold the
  same replicated activations and each holds the full gradient of a
  replicated parameter; ranks of a ``data`` slice hold different samples
  and the trainer averages their gradients. ``copy_to`` (identity, then a
  summed gradient) and ``reduce_from`` (a sum, then the gradient as is)
  are Megatron's pair; ``all_reduce`` sums both ways (a value that enters
  every rank's loss alike, from every rank's part); ``split_to`` takes
  this rank's chunk and gathers the gradient; ``gather_from`` gathers the
  chunks and hands back this rank's chunk of the gradient.

gloo moves host memory. A CUDA tensor on a gloo group (several ranks
sharing one card, ``Engine.init(backend="gloo")``) is staged through the
host by one rule (``_staged``), for every collective alike: copied to the
CPU, moved there, copied back. NCCL groups take CUDA tensors directly,
and only their collectives can be captured in a CUDA graph
(``utils/programs.py``); :func:`capturable` says which.
``torch.distributed.nn.functional`` is not used: it is deprecated.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

SUM = dist.ReduceOp.SUM
MAX = dist.ReduceOp.MAX


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def capturable(group) -> bool:
    """Whether ``group``'s collectives may be captured in a CUDA graph:
    NCCL's are; gloo's run on the host."""
    return not _gloo(group)


def size(group) -> int:
    return dist.get_world_size(group)


def index(group) -> int:
    """This rank's position in ``group``."""
    return dist.get_rank(group)


def _staged(group, tensors) -> tuple:
    """(the tensors a collective of ``group`` runs on, whether they were
    staged): host copies when ``group`` is gloo and a tensor is on the
    card, else the tensors themselves, contiguous. The one place that
    knows gloo's rule."""
    stage = _gloo(group) and any(t.is_cuda for t in tensors)
    return ([t.detach().cpu() if stage else t.contiguous()
             for t in tensors], stage)


def _run(group, op, outs=(), ins=()) -> None:
    """``op(*outs, *ins)`` over ``group``, on staged tensors
    (:func:`_staged`); what ``op`` wrote into the staged ``outs`` is
    copied back into ``outs``."""
    work, stage = _staged(group, [*outs, *ins])
    op(*work)
    for o, w in zip(outs, work):
        if w is not o:
            o.copy_(w)


def all_reduce_(t: torch.Tensor, group, op=SUM) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (sum by default)."""
    _run(group, lambda w: dist.all_reduce(w, op=op, group=group), (t,))
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``."""
    _run(group, lambda w: dist.broadcast(w, src=src, group=group), (t,))
    return t


def all_gather_into(out: torch.Tensor, inp: torch.Tensor,
                    group) -> torch.Tensor:
    """``out`` (n · inp.numel() elements) = the ranks' ``inp`` in order."""
    _run(group, lambda o, i: dist.all_gather_into_tensor(
        o.view(-1), i.view(-1), group=group), (out,), (inp,))
    return out


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor,
                        group) -> torch.Tensor:
    """``out`` = this rank's chunk of the sum over ranks of ``inp``."""
    _run(group, lambda o, i: dist.reduce_scatter_tensor(
        o.view(-1), i.view(-1), op=SUM, group=group), (out,), (inp,))
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (no gradient)."""
    n = size(group)
    xd = x.movedim(dim, 0).contiguous()
    out = xd.new_empty((n * xd.shape[0],) + tuple(xd.shape[1:]))
    all_gather_into(out, xd, group)
    return out.movedim(0, dim)


def barrier(group=None) -> None:
    dist.barrier(group=group)


def ring_shift(tensors, group, step: int = 1) -> list:
    """Each rank sends ``tensors`` to the rank ``step`` places after it in
    ``group`` and returns what the rank ``step`` places before it sent."""
    n = size(group)
    if n == 1:
        return list(tensors)
    me = index(group)
    to = dist.get_global_rank(group, (me + step) % n)
    frm = dist.get_global_rank(group, (me - step) % n)
    got = [torch.empty_like(t) for t in tensors]

    def shift(*work):
        sent, into = work[len(got):], work[:len(got)]
        ops = [dist.P2POp(dist.isend, t, to, group) for t in sent] \
            + [dist.P2POp(dist.irecv, t, frm, group) for t in into]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    _run(group, shift, got, tensors)
    return got


def isend(t: torch.Tensor, dst_index: int, group):
    """Start sending ``t`` to the rank at ``dst_index`` of ``group``;
    returns ``(work, buffer)``: keep both until ``work.wait()``."""
    dst = dist.get_global_rank(group, dst_index)
    (w,), _ = _staged(group, [t.detach()])
    return dist.isend(w, dst, group=group), w


def recv(like: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """Receive a tensor shaped like ``like`` from ``src_index`` of
    ``group``."""
    src = dist.get_global_rank(group, src_index)
    buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    _run(group, lambda w: dist.recv(w, src, group=group), (buf,))
    return buf


# ------------------------------------------------ collectives with gradients
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, i = size(group), index(group)
        return x.chunk(n, dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = size(ctx.group), index(ctx.group)
        return g.chunk(n, ctx.dim)[i].contiguous(), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the gradient passes as is."""
    return _ReduceFrom.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, the gradient summed too."""
    return _AllReduce.apply(x, group)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim``; the gradient gathered."""
    return _SplitTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' chunks concatenated along ``dim``; this rank's chunk of
    the gradient."""
    return _GatherFrom.apply(x, group, dim)


# ------------------------------------------------------- the step's context
class _Ctx:
    data = None          # the data-parallel group of the running step
    averages = True      # whether the trainer averages the ranks' losses


_CTX = _Ctx()


class data_parallel:
    """While a trainer's step runs, the group its batch is split over:
    layers and criteria that mix samples (batch norm's moments, a mean
    over a data-dependent count, MoE's routing) reduce over it, so each
    rank computes JAX's global-batch result."""

    def __init__(self, group, averages: bool = True):
        self.group, self.averages = group, averages

    def __enter__(self):
        self.prev = (_CTX.data, _CTX.averages)
        _CTX.data, _CTX.averages = self.group, self.averages
        return self

    def __exit__(self, *exc):
        _CTX.data, _CTX.averages = self.prev


def data_group() -> Optional[object]:
    """The data-parallel group of the running step, or None."""
    return _CTX.data


def scale_sample_sum(t: torch.Tensor) -> torch.Tensor:
    """A loss term summed over this rank's samples (an activity penalty),
    scaled so that the trainer's reduction of the ranks' losses counts
    every rank's term once."""
    group = _CTX.data
    if group is None or not _CTX.averages:
        return t
    return t * size(group)


def scale_replicated(t: torch.Tensor) -> torch.Tensor:
    """A loss term every rank computes alike (a weight penalty, a global
    routing loss), scaled so that the trainer's reduction counts it
    once."""
    group = _CTX.data
    if group is None or _CTX.averages:
        return t
    return t / size(group)


def global_mean(total: torch.Tensor, count: torch.Tensor,
                min_count: Optional[float] = None) -> torch.Tensor:
    """``total / count`` as a rank's share of the global mean: outside a
    data-parallel step that mean itself; inside, ``total / N · D`` with
    ``N`` the count summed over the ``D`` ranks, so the ranks' average
    (what the trainer takes) is the global mean even where the ranks'
    counts differ (ignored labels, padding). ``min_count`` clamps the
    global count from below, as JAX's ``maximum(count, 1)`` does, so a
    batch with nothing to count gives 0 and not 0/0."""
    group = _CTX.data
    n = count.detach().to(total.dtype)
    if group is not None:
        n = all_reduce_(n.clone(), group)
    if min_count is not None:
        n = n.clamp(min=min_count)
    return total / n if group is None else total / n * size(group)
