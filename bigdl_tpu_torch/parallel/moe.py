"""Mixture-of-Experts with expert parallelism.

Counterpart of ``bigdl_tpu/parallel/moe.py:29-259``: the Switch/GShard MLP
block with ``top1``, ``top2`` and ``expert_choice`` routing, GShard's
dense dispatch and combine (three einsums), ``capacity_factor`` (the
capacity ``ceil(n_select · tokens · capacity_factor / n_experts)``),
``z_loss_weight`` and the router-health state leaves (``aux_loss``,
``router_z_loss``, ``dropped_fraction``, ``expert_load``,
``expert_load_max``, and ``penalty`` with a z-loss), kept as persistent
buffers and rewritten by every forward, as JAX's ``apply`` returns them.
The load-balance loss reaches the trainer through
``nn.misc.collecting_aux_losses`` (scaled by ``set_aux_loss_weight``),
the z-loss through the penalties at full strength.

**Global routing.** JAX routes the global batch; a port rank holds a
contiguous block of it (``P("data")``). Under a data-parallel step
(``parallel/collectives.data_parallel``) the layer makes each rank's
routing JAX's: the capacity comes from the global token count; a token's
place in an expert's buffer follows the global token order, its local
cumulative count offset by the lower ranks' per-expert counts (one
all-gather of ``(n_experts,)`` counts; a second for top-2's second
choices, which queue behind every first choice of the batch); expert
choice picks each expert's tokens over the router scores gathered from
the whole batch; ``aux_loss``, ``router_z_loss`` and ``dropped_fraction``
are global means.

**Expert parallelism** (``expert_parallel_rules`` through
``DistriOptimizer.set_tensor_parallel``): a rank of the ``model`` slice
holds ``n_experts / tp`` experts. Routing runs on every rank of the slice
alike (their tokens are the same); a rank runs its experts on the tokens
dispatched to them and the combine is summed over the slice. The router
and the input enter by ``copy_to``, so their gradients, each rank's part
through its own experts, are summed; the routing losses, which every rank
computes whole, enter with their gradient divided by ``tp``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomNormal
from bigdl_tpu_torch.parallel import collectives as C
from bigdl_tpu_torch.parallel.sharding import P
from bigdl_tpu_torch.parallel.tensor_parallel import TPRules


def _one_hot(pos: torch.Tensor, n: int, keep: torch.Tensor) -> torch.Tensor:
    """JAX's ``one_hot(pos, n)`` (zeros out of range) times ``keep``."""
    idx = pos.long().clamp(0, n - 1)
    return F.one_hot(idx, n).float() * keep[..., None].float()


def _counts_before(counts: torch.Tensor, group) -> tuple:
    """(the lower ranks' counts summed, every rank's counts summed) over
    ``group`` (no gradient); zeros and ``counts`` without one."""
    if group is None:
        return torch.zeros_like(counts), counts
    all_counts = C.all_gather_cat(counts[None], group, 0)
    r = C.index(group)
    return all_counts[:r].sum(0), all_counts.sum(0)


class MoE(TensorModule):
    """Switch/GShard MoE MLP block: (N, D) or (N, T, D) in, same shape out.
    Overflow tokens get combine weight zero (their output is zero)."""

    def __init__(self, input_size: int, hidden_size: int, n_experts: int,
                 capacity_factor: float = 1.25, router: str = "top1",
                 z_loss_weight: float = 0.0,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if router not in ("top1", "top2", "expert_choice"):
            raise ValueError(f"router must be 'top1', 'top2' or "
                             f"'expert_choice', got {router!r}")
        if n_experts < 2:
            raise ValueError(f"n_experts must be >= 2, got {n_experts!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.router = router
        self.n_select = 2 if router == "top2" else 1
        self.z_loss_weight = float(z_loss_weight)
        init = w_init or RandomNormal(0.0, 0.02)
        d, h, e = input_size, hidden_size, n_experts

        def mk(shape, fan_in, fan_out):
            return torch.nn.Parameter(init.init(shape, fan_in, fan_out,
                                                generator=generator))

        self.w_gate = mk((d, e), d, e)
        self.w1 = mk((e, d, h), d, h)
        self.b1 = torch.nn.Parameter(torch.zeros(e, h))
        self.w2 = mk((e, h, d), h, d)
        self.b2 = torch.nn.Parameter(torch.zeros(e, d))
        for name in ("aux_loss", "router_z_loss", "dropped_fraction",
                     "expert_load_max"):
            self.register_buffer(name, torch.zeros(()))
        self.register_buffer("expert_load", torch.zeros(e))
        if self.z_loss_weight > 0:
            self.register_buffer("penalty", torch.zeros(()))
        self._ep = None          # (group, tp, index, axis): expert parallel

    def set_expert_parallel(self, group, n: int, i: int,
                            axis: str = "model") -> None:
        """Keep only experts ``[i·E/n, (i+1)·E/n)`` (their leaves sliced)
        and run them over ``group`` (the slice of mesh ``axis``)."""
        if self.n_experts % n:
            raise ValueError(f"n_experts {self.n_experts} not divisible by "
                             f"the expert-parallel size {n}")
        for name in ("w1", "b1", "w2", "b2"):
            t = getattr(self, name)
            setattr(self, name, torch.nn.Parameter(
                t.detach().chunk(n, 0)[i].clone()))
        self._ep = (group, n, i, axis)

    def tp_leaves(self) -> dict:
        """``{leaf: (split dim, axis)}`` of the expert leaves this rank
        holds a slice of (empty off expert parallelism)."""
        return ({k: (0, self._ep[3]) for k in ("w1", "b1", "w2", "b2")}
                if self._ep is not None else {})

    def _capacity(self, n_tokens: int) -> int:
        cap = math.ceil(self.n_select * n_tokens * self.capacity_factor
                        / self.n_experts)
        return max(cap, 1)

    def _expert_mlp(self, dispatch, combine, x):
        if self._ep is not None:
            _, n, i, _ = self._ep
            k = self.n_experts // n
            dispatch = dispatch[:, i * k:(i + 1) * k]
            combine = combine[:, i * k:(i + 1) * k]
        xin = torch.einsum("tec,td->ecd", dispatch, x.float())
        hmid = torch.relu(torch.einsum("ecd,edh->ech", xin, self.w1)
                          + self.b1[:, None, :])
        out_e = torch.einsum("ech,ehd->ecd", hmid, self.w2) \
            + self.b2[:, None, :]
        y = torch.einsum("tec,ecd->td", combine, out_e)
        if self._ep is not None:
            y = C.reduce_from(y, self._ep[0])
        return y.to(x.dtype)

    def _global_mean(self, local_sum, n_global, group, grad=True):
        if group is not None:
            local_sum = (C.all_reduce(local_sum, group) if grad
                         else C.all_reduce_(local_sum.detach().clone(), group))
        return local_sum / n_global

    def _loss_term(self, t: torch.Tensor) -> torch.Tensor:
        """A routing loss every rank of an expert-parallel slice computes
        whole: its gradient divided by the slice's size, its value kept."""
        if self._ep is None:
            return t
        n = self._ep[1]
        return t / n + (t - t / n).detach()

    def run(self, input, state=None):
        x = input
        flat = x.dim() == 3
        if flat:
            n, t, d = x.shape
            x = x.reshape(n * t, d)
        group = C.data_group()
        ranks = C.size(group) if group is not None else 1
        tokens = x.shape[0]
        n_global = tokens * ranks
        e = self.n_experts
        cap = self._capacity(n_global)
        w_gate = self.w_gate
        if self._ep is not None:
            x = C.copy_to(x, self._ep[0])
            w_gate = C.copy_to(w_gate, self._ep[0])
        logits = x @ w_gate.to(x.dtype)
        probs = torch.softmax(logits.float(), dim=-1)
        if self.router == "expert_choice":
            dispatch, combine, frac = self._expert_choice(probs, cap,
                                                          n_global, group)
            aux = None
        else:
            dispatch, combine, frac = self._top_k(probs, cap, n_global,
                                                  group)
            mean_prob = self._global_mean(probs.sum(0), n_global, group)
            aux = e * (frac * mean_prob).sum()
        y = self._expert_mlp(dispatch, combine, x)
        z = torch.logsumexp(logits.float(), dim=-1)
        z_loss = self._global_mean(z.square().sum(), n_global, group)
        got = (combine.sum((1, 2)) > 0).float().sum()
        dropped = 1.0 - self._global_mean(got, n_global, group, grad=False)
        from bigdl_tpu_torch.nn.misc import declare_aux_loss, declare_penalty
        if aux is not None:
            declare_aux_loss(C.scale_replicated(self._loss_term(aux)))
        if self.z_loss_weight > 0:
            declare_penalty(C.scale_replicated(
                self._loss_term(self.z_loss_weight * z_loss)))
        with torch.no_grad():
            self.aux_loss.copy_(aux if aux is not None else 0.0)
            self.router_z_loss.copy_(z_loss)
            self.dropped_fraction.copy_(dropped)
            self.expert_load.copy_(frac)
            self.expert_load_max.copy_(frac.max())
            if self.z_loss_weight > 0:
                self.penalty.copy_(self.z_loss_weight * z_loss)
        if flat:
            y = y.reshape(n, t, d)
        return y, state

    def _top_k(self, probs, cap, n_global, group):
        e = self.n_experts
        expert1 = probs.argmax(-1)
        gate1 = probs.gather(1, expert1[:, None])[:, 0]
        onehot1 = F.one_hot(expert1, e).float()
        before1, total1 = _counts_before(onehot1.sum(0), group)
        pos1 = (onehot1.cumsum(0) + before1) * onehot1 - 1.0
        keep1 = (pos1 < cap) & (onehot1 > 0)
        disp1 = _one_hot(pos1, cap, keep1)
        if self.n_select == 2:
            probs2 = probs * (1.0 - onehot1)
            expert2 = probs2.argmax(-1)
            gate2 = probs.gather(1, expert2[:, None])[:, 0]
            onehot2 = F.one_hot(expert2, e).float()
            before2, _ = _counts_before(onehot2.sum(0), group)
            pos2 = (onehot2.cumsum(0) + before2 + total1) * onehot2 - 1.0
            keep2 = (pos2 < cap) & (onehot2 > 0)
            disp2 = _one_hot(pos2, cap, keep2)
            dispatch = disp1 + disp2
            denom = gate1 + gate2 + 1e-9
            combine = (disp1 * (gate1 / denom)[:, None, None]
                       + disp2 * (gate2 / denom)[:, None, None])
        else:
            dispatch = disp1
            combine = disp1 * gate1[:, None, None]
        frac = self._global_mean(onehot1.sum(0), n_global, group, grad=False)
        return dispatch, combine, frac

    def _expert_choice(self, probs, cap, n_global, group):
        e = self.n_experts
        tokens = probs.shape[0]
        cap = min(cap, n_global)
        scores = probs.detach()
        lo = 0
        if group is not None:
            scores = C.all_gather_cat(scores, group, 0)
            lo = C.index(group) * tokens
        idx = torch.topk(scores.t(), cap, dim=-1).indices - lo   # (E, C)
        inside = (idx >= 0) & (idx < tokens)
        dispatch = _one_hot(idx, tokens, inside).permute(2, 0, 1)
        combine = dispatch * probs[:, :, None]
        top = F.one_hot(probs.argmax(-1), e).float().sum(0)
        frac = self._global_mean(top, n_global, group, grad=False)
        return dispatch, combine, frac

    def extra_repr(self):
        return (f"{self.input_size}, hidden={self.hidden_size}, "
                f"experts={self.n_experts}, router={self.router}")


def expert_parallel_rules(moe_path_prefix: str = "", axis: str = "model",
                          rules: Optional[TPRules] = None) -> TPRules:
    """TPRules splitting an MoE block's expert leaves (w1, b1, w2, b2) on
    the expert dim over ``axis``; the gate stays replicated."""
    import re as _re
    r = rules if rules is not None else TPRules()
    pre = (f"(^|/){_re.escape(moe_path_prefix)}/" if moe_path_prefix
           else "(^|/)")
    r.add(f"{pre}w1$", P(axis, None, None))
    r.add(f"{pre}b1$", P(axis, None))
    r.add(f"{pre}w2$", P(axis, None, None))
    r.add(f"{pre}b2$", P(axis, None))
    return r

