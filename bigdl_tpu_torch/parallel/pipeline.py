"""Pipeline parallelism: ``GPipe`` over the mesh's ``pipe`` axis.

Counterpart of ``bigdl_tpu/parallel/pipeline.py``: the homogeneous form
(``GPipe(stage, n_stages=S)``: S copies of one module, each a stage;
unlike JAX's ``clone().reset()`` the copies start from ``stage``'s
weights) and the heterogeneous one (``GPipe(stages=[...])``, each stage
its own module, its own parameters and boundary shapes),
``n_microbatches``, ``remat`` and ``schedule="gpipe"`` or ``"1f1b"``. JAX's
stage checks stay (``_check_stage``): stages hold no state (no persistent
buffers: batch norm's statistics would part between ranks) and draw no
random numbers.

JAX runs every stage in one SPMD program (a ``lax.switch`` on the pipe
rank, flat padded buffers on the wire, autodiff through ``scan`` and
``ppermute``). A port rank of the ``pipe`` slice runs only its own
stage: activations cross by ``send``/``recv`` (a small header first
carries the shape), so no buffers are padded. Off the mesh (no ``pipe``
axis of size S) the stages run one after the other on the whole batch,
as in JAX.

Training (``pipeline_train_step``, which ``DistriOptimizer`` runs for a
root ``GPipe`` on a pipe mesh under either schedule): the criterion runs
inside the pipeline on each microbatch, scaled by ``1/M`` for averaging
criteria, and each backward is an explicit ``torch.autograd.grad`` of the
rank's stage. ``"gpipe"`` runs every forward, then every backward, keeping
the M stage graphs (with ``remat``: only the stage inputs, the forward
recomputed at its backward); ``"1f1b"`` runs JAX's statically simulated
PipeDream-flush order (``_simulate_1f1b``, the same table), holding at
most ``min(S - rank, M)`` stage inputs and recomputing each forward at its
backward. Both accumulate a stage's gradients in microbatch order, so
their gradients are bitwise equal. Sends are non-blocking (``isend``,
waited at the step's end), so the 1F1B interleave cannot deadlock. The
loss is broadcast from the last stage; the gradients of a rank are those
of its own stage's parameters (the trainer averages them over ``data``).
Under a mixed-precision compute dtype each stage runs on its parameters
and input cast to that dtype and hands fp32 on (JAX casts each stage's
flat row the same way).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container
from bigdl_tpu_torch.parallel import collectives as C


def _simulate_1f1b(s: int, m: int):
    """JAX's static simulation of the non-interleaved 1F1B schedule
    (``bigdl_tpu/parallel/pipeline.py:69``): int32 tables (T, S) of the
    microbatch whose forward (``f_tab``) and backward (``b_tab``) rank r
    runs at tick t (-1: none), and of the arrivals (``rf_tab``,
    ``rb_tab``)."""
    next_f = [0] * s
    next_b = [0] * s
    f_done = [[None] * m for _ in range(s)]
    b_done = [[None] * m for _ in range(s)]
    rows = []
    t = 0
    while any(next_b[r] < m for r in range(s)):
        row = []
        for r in range(s):
            f_i = b_i = -1
            can_f = (next_f[r] < m
                     and (next_f[r] - next_b[r]) < min(s - r, m))
            if can_f and r > 0:
                up = f_done[r - 1][next_f[r]]
                can_f = up is not None and up + 1 <= t
            can_b = next_b[r] < next_f[r]
            if can_b:
                i = next_b[r]
                if r == s - 1:
                    can_b = f_done[r][i] is not None and f_done[r][i] < t
                else:
                    dn = b_done[r + 1][i]
                    can_b = dn is not None and dn + 1 <= t
            if can_b:
                b_i = next_b[r]
            elif can_f:
                f_i = next_f[r]
            row.append((f_i, b_i))
        for r, (f_i, b_i) in enumerate(row):
            if f_i >= 0:
                assert all((j - f_i) % s != 0
                           for j in range(next_b[r], next_f[r])), \
                    "1F1B stash ring collision"
                f_done[r][f_i] = t
                next_f[r] += 1
            if b_i >= 0:
                b_done[r][b_i] = t
                next_b[r] += 1
        rows.append(row)
        t += 1
        if t > 6 * (m + s) + 32:
            raise RuntimeError("1F1B schedule simulation did not converge")
    n_ticks = len(rows)
    f_tab = np.full((n_ticks, s), -1, np.int32)
    b_tab = np.full((n_ticks, s), -1, np.int32)
    rf_tab = np.full((n_ticks, s), -1, np.int32)
    rb_tab = np.full((n_ticks, s), -1, np.int32)
    for tt, row in enumerate(rows):
        for r, (f_i, b_i) in enumerate(row):
            f_tab[tt, r] = f_i
            b_tab[tt, r] = b_i
            if f_i >= 0 and r + 1 < s and tt + 1 < n_ticks:
                rf_tab[tt + 1, r + 1] = f_i
            if b_i >= 0 and r - 1 >= 0 and tt + 1 < n_ticks:
                rb_tab[tt + 1, r - 1] = b_i
    for r in range(s):
        assert sorted(i for i in f_tab[:, r] if i >= 0) == list(range(m))
        assert sorted(i for i in b_tab[:, r] if i >= 0) == list(range(m))
    return f_tab, b_tab, rf_tab, rb_tab


def _check_stage(stage: AbstractModule) -> AbstractModule:
    from bigdl_tpu_torch.convert import module_state
    if module_state(stage):
        raise ValueError(
            "GPipe stages must be stateless: per-rank running statistics "
            "(e.g. BatchNorm) would silently diverge across pipeline ranks. "
            "Use LayerNorm in pipelined stacks instead.")
    if any(getattr(m, "draws_random", False)
           and float(getattr(m, "p", 1.0)) > 0 for m in stage.modules()):
        raise ValueError(
            "GPipe stages must not need RNG (build blocks with dropout=0); "
            "the pipeline schedule replays stages across microbatch ticks")
    return stage


_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]
_HEADER = 10


def _send_act(t: torch.Tensor, dst: int, group, pending: list) -> None:
    head = torch.zeros(_HEADER, dtype=torch.int64)
    head[0] = _DTYPES.index(t.dtype)
    head[1] = t.dim()
    head[2:2 + t.dim()] = torch.tensor(t.shape)
    pending.append(C.isend(head.to(t.device), dst, group))
    pending.append(C.isend(t, dst, group))


def _recv_act(src: int, group, device) -> torch.Tensor:
    head = C.recv(torch.zeros(_HEADER, dtype=torch.int64, device=device),
                  src, group).cpu()
    shape = tuple(int(d) for d in head[2:2 + int(head[1])])
    like = torch.empty(shape, dtype=_DTYPES[int(head[0])], device=device)
    return C.recv(like, src, group)


class GPipe(Container):
    """Pipeline container. ``GPipe(stage, n_stages=S)`` composes S copies;
    ``GPipe(stages=[...])`` pipelines heterogeneous modules. Runs as a
    pipeline over the ``pipe`` mesh axis when its size is S."""

    def __init__(self, stage: Optional[AbstractModule] = None,
                 n_stages: int = 1, n_microbatches: int = 2,
                 axis_name: str = "pipe",
                 stages: Optional[Sequence[AbstractModule]] = None,
                 remat: bool = False, schedule: str = "gpipe"):
        if (stage is None) == (stages is None):
            raise ValueError("pass exactly one of `stage` or `stages`")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"schedule must be 'gpipe' or '1f1b', got {schedule!r}")
        if stages is not None:
            mods = [_check_stage(m) for m in stages]
            n_stages = len(mods)
            homogeneous = False
        else:
            _check_stage(stage)
            mods = [stage] + [copy.deepcopy(stage)
                              for _ in range(n_stages - 1)]
            homogeneous = True
        super().__init__(*mods)
        self.schedule = schedule
        self.remat = bool(remat)
        self.homogeneous = homogeneous
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.axis_name = axis_name

    def pipe_mesh(self):
        """The Engine mesh when its ``pipe`` axis runs this pipeline."""
        from bigdl_tpu_torch.utils.engine import Engine
        mesh = Engine.mesh_if_up()
        if mesh is None or self.n_stages < 2 \
                or mesh.axis_size(self.axis_name) != self.n_stages:
            return None
        return mesh

    def _micro(self, x):
        m = self.n_microbatches
        if x.shape[0] % m != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"n_microbatches {m}")
        return x.chunk(m, 0)

    def run(self, input, state=None):
        mesh = self.pipe_mesh()
        if mesh is None:
            y = input
            for i in range(self.n_stages):
                y = self[i](y)
            return y, state
        group = mesh.group(self.axis_name)
        r, s = mesh.index(self.axis_name), self.n_stages
        micro = self._micro(input)
        outs, pending = [], []
        for mb in range(self.n_microbatches):
            inp = micro[mb] if r == 0 else _recv_act(r - 1, group,
                                                     input.device)
            out = self[r](inp)
            if r < s - 1:
                _send_act(out, r + 1, group, pending)
            else:
                outs.append(out)
        for work, _ in pending:
            work.wait()
        # the output lives on the last stage: every rank gets it
        last = C.dist.get_global_rank(group, s - 1)
        if r == s - 1:
            y = torch.cat(outs, 0)
            head = torch.zeros(_HEADER, dtype=torch.int64)
            head[0] = _DTYPES.index(y.dtype)
            head[1] = y.dim()
            head[2:2 + y.dim()] = torch.tensor(y.shape)
        else:
            head = torch.zeros(_HEADER, dtype=torch.int64)
        C.broadcast_(head, last, group)
        if r != s - 1:
            shape = tuple(int(d) for d in head[2:2 + int(head[1])])
            y = torch.empty(shape, dtype=_DTYPES[int(head[0])],
                            device=input.device)
        C.broadcast_(y, last, group)
        return y, state

    def stage_params(self, mesh=None) -> dict:
        """``{path: parameter}`` of this rank's stage on a pipe mesh."""
        mesh = mesh or self.pipe_mesh()
        r = mesh.index(self.axis_name)
        return {f"{r}.{n}": p for n, p in self[r].named_parameters()}

    def pipeline_train_step(self, x, y, criterion, prefix: str = ""):
        """One pipelined forward and backward of the batch ``(x, y)`` under
        ``self.schedule``: returns ``(loss, grads)``, the loss broadcast to
        every rank of the slice and ``grads`` by parameter path (with
        ``prefix``) for this rank's stage. Under a mixed-precision compute
        dtype (``Engine``), as in JAX (``bigdl_tpu/parallel/pipeline.py:
        448-462``), a stage runs on its parameters and its floating input
        cast to that dtype, its output returns to fp32 (the wires and the
        criterion are fp32), and the casts' backward gives fp32 gradients
        of the masters."""
        from bigdl_tpu_torch.utils.engine import Engine
        dtype = Engine.compute_dtype()
        mesh = self.pipe_mesh()
        group = mesh.group(self.axis_name)
        r, s, m = mesh.index(self.axis_name), self.n_stages, \
            self.n_microbatches
        stage = self[r]
        params = [p for p in stage.parameters()]
        if dtype != torch.float32:
            from torch.func import functional_call

            from bigdl_tpu_torch.nn.precision import cast_floating

            def run(inp):
                cast = cast_floating(dict(stage.named_parameters()), dtype)
                out = functional_call(stage, cast,
                                      (cast_floating(inp, dtype),))
                return cast_floating(out, torch.float32)
        else:
            run = stage
        names = [f"{prefix}{r}.{n}" for n, _ in stage.named_parameters()]
        mx, my = self._micro(x), self._micro(y)
        averages = bool(getattr(criterion, "size_average", True))
        scale = 1.0 / m if averages else 1.0
        if self.schedule == "1f1b":
            f_tab, b_tab, _, _ = _simulate_1f1b(s, m)
            ops = []
            for t in range(f_tab.shape[0]):
                if f_tab[t, r] >= 0:
                    ops.append(("F", int(f_tab[t, r])))
                if b_tab[t, r] >= 0:
                    ops.append(("B", int(b_tab[t, r])))
            recompute = True
        else:
            ops = [("F", i) for i in range(m)] + [("B", i) for i in range(m)]
            recompute = self.remat
        stash: dict = {}
        pending: list = []
        gsum = [torch.zeros_like(p) for p in params]
        loss_acc = torch.zeros((), device=x.device)
        dev = x.device
        for kind, mb in ops:
            if kind == "F":
                inp = mx[mb] if r == 0 else _recv_act(r - 1, group, dev)
                if r > 0 and inp.is_floating_point():
                    inp.requires_grad_(True)
                if recompute:
                    out = None
                    if r < s - 1:
                        with torch.no_grad():
                            _send_act(run(inp), r + 1, group, pending)
                else:
                    out = run(inp)
                    if r < s - 1:
                        _send_act(out.detach(), r + 1, group, pending)
                stash[mb] = (inp, out)
            else:
                inp, out = stash.pop(mb)
                if out is None:
                    out = run(inp)
                wrt = params + ([inp] if inp.requires_grad else [])
                if r == s - 1:
                    loss = criterion.apply(out, my[mb]) * scale
                    grads = torch.autograd.grad(loss, wrt,
                                                allow_unused=True)
                    loss_acc = loss_acc + loss.detach()
                else:
                    g = C.recv(out, r + 1, group)
                    grads = torch.autograd.grad(out, wrt, g,
                                                allow_unused=True)
                for i, gr in enumerate(grads[:len(params)]):
                    if gr is not None:
                        gsum[i] = gsum[i] + gr
                if r > 0:
                    pending.append(C.isend(grads[-1], r - 1, group))
        for work, _ in pending:
            work.wait()
        C.broadcast_(loss_acc, C.dist.get_global_rank(group, s - 1), group)
        return loss_acc, dict(zip(names, gsum))

    def extra_repr(self):
        kind = "homogeneous" if self.homogeneous else "heterogeneous"
        return (f"stages={self.n_stages} [{kind}], "
                f"microbatches={self.n_microbatches}, "
                f"schedule={self.schedule}")
