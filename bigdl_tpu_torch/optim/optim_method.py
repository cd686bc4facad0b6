"""Optimization methods: SGD (with learning-rate schedules and per-layer
multipliers), Adam, AdamW, Adagrad, Adadelta, Adamax, RMSprop, Ftrl,
LarsSGD, LBFGS and the per-submodule CompositeOptimMethod.

Counterpart of ``bigdl_tpu/optim/optim_method.py``. JAX's methods are pure
transforms ``update(params, grads, state, step) -> (new_params,
new_state)``; here ``update`` writes the new values into the parameter and
slot tensors in place under ``torch.no_grad()`` (a copy of every parameter
per step would double the update's memory traffic). ``params`` and
``grads`` are a sequence of tensors or a dict of them keyed by parameter
path (``"0.1.weight"``, as ``named_parameters()`` gives it; a sequence
counts as keys ``"0"``, ``"1"``, ...); slots are lists in the same order.
The arithmetic follows JAX: ``step`` is 0-based, the default decay is
``lr / (1 + step · decay)``, and bias corrections use ``t = step + 1``.

The numbers that change from step to step (decayed rates, bias
corrections) are computed on the host by :meth:`OptimMethod.hyper`, as
Python floats, and reach the update as one small fp32 tensor on the
parameters' device (:meth:`OptimMethod.update_with`): a captured training
step (``optim/optimizer.py``) would freeze a Python number at its capture
value, and the trainer rewrites the tensor before each replay.
``update(params, grads, state, step)`` makes that tensor and calls
``update_with``, on the CPU too, so every path runs the same arithmetic.
No update reads a value back to the host.

Frozen parameters (``freeze()``, gradient scale 0) carry no slots:
``init_state_trimmed`` and ``update_with_trimmed`` show the method 0-size
stand-ins for them, as JAX does, so every slot of a frozen leaf is empty
and its parameter is never written.
"""

from __future__ import annotations

from typing import Optional

import torch


def decayed_lr(learningrate: float, learningrate_decay: float,
               step: float) -> float:
    """The reference's default decay: ``lr / (1 + step * decay)``."""
    return learningrate / (1.0 + step * learningrate_decay)


def leaves(tree) -> list:
    """The tensors of ``tree`` (a dict or a sequence), in order."""
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def leaf_names(tree) -> list:
    """Each tensor's path: the dict's keys, or ``"0"``, ``"1"``, ... for a
    sequence (JAX's tests key a flat params dict the same way)."""
    if isinstance(tree, dict):
        return list(tree)
    return [str(i) for i in range(len(tree))]


def keystr(name: str) -> str:
    """A dotted parameter path in JAX's ``keystr`` form, ``['0']['weight']``,
    the string ``layer_lr_mults`` patterns are matched against."""
    return "".join(f"['{part}']" for part in name.split("."))


def _zeros(params) -> list:
    return [torch.zeros_like(p) for p in leaves(params)]


def hyper_tensor(values, params) -> torch.Tensor:
    """``values`` (host floats) as an fp32 tensor on the device of the
    first of ``params``."""
    ps = leaves(params)
    dev = ps[0].device if ps else torch.device("cpu")
    return torch.tensor(values, dtype=torch.float32, device=dev)


class OptimMethod:
    #: True when ``update`` is a purely elementwise map over the param,
    #: grad and slot tensors (no per-leaf norms, no path-keyed routing):
    #: such a method may run over dtype-grouped flat vectors
    #: (``kernels/fused_update.py``) with bit-for-bit the same result.
    elementwise_update = False

    def init_state(self, params) -> dict:
        """Slots for ``params`` (lists of tensors shaped like them)."""
        return {}

    def hyper(self, step: int, state: dict) -> list:
        """The update's step-dependent numbers at the 0-based ``step``, on
        the host, in the order :meth:`update_with` reads them; as many at
        every step."""
        return []

    def update_with(self, params, grads, state: dict,
                    h: torch.Tensor) -> None:
        """Step ``params`` and ``state`` in place, reading the step's
        numbers from ``h`` (fp32, ``hyper(step, state)``, on the
        parameters' device)."""
        raise NotImplementedError

    def update(self, params, grads, state: dict, step: int) -> None:
        """Step ``params`` and ``state`` in place; ``step`` is 0-based."""
        self.update_with(params, grads, state,
                         hyper_tensor(self.hyper(step, state), params))

    # ---------------------------------------------- frozen-leaf trimming
    @staticmethod
    def _mask_frozen(tree, trainable):
        """``tree`` with every frozen leaf replaced by a 0-size tensor."""
        masked = [p if t else torch.empty(0, dtype=p.dtype, device=p.device)
                  for p, t in zip(leaves(tree), trainable)]
        if isinstance(tree, dict):
            return dict(zip(tree, masked))
        return masked

    def init_state_trimmed(self, params, trainable=None) -> dict:
        """``init_state`` with frozen leaves (``trainable[i]`` False) trimmed
        to 0-size slots; ``trainable=None`` means every leaf trains."""
        if trainable is None:
            return self.init_state(params)
        return self.init_state(self._mask_frozen(params, trainable))

    def update_with_trimmed(self, params, grads, state, h,
                            trainable=None) -> None:
        """:meth:`update_with` against trimmed slots: the method sees 0-size
        frozen leaves (its elementwise work there is empty) and frozen
        parameters stay untouched. A frozen leaf's gradient may be anything
        (the trainer computes none)."""
        if trainable is None:
            return self.update_with(params, grads, state, h)
        ref = leaves(params)
        g = [gr if t else torch.empty(0, dtype=p.dtype, device=p.device)
             for gr, p, t in zip(leaves(grads), ref, trainable)]
        if isinstance(params, dict):
            g = dict(zip(params, g))
        return self.update_with(self._mask_frozen(params, trainable), g,
                                state, h)

    def get_learning_rate(self, step: int) -> float:
        return 0.0

    def __repr__(self):
        return type(self).__name__


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov and weight decay, at the
    reference's default decayed rate or a ``learningrate_schedule``
    (``optim/schedules.py``). A stateful schedule (``Plateau``) keeps its
    current rate in the optimizer state as ``state["clr"]``.
    ``layer_lr_mults`` maps a substring of a parameter's path (in JAX's
    ``keystr`` form, ``['3']['weight']``; first match wins) to a per-layer
    rate multiplier."""

    elementwise_update = True    # flat-eligible unless layer_lr_mults set

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False, learningrate_schedule=None,
                 layer_lr_mults: Optional[dict] = None):
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.learningrate_schedule = learningrate_schedule
        self.layer_lr_mults = dict(layer_lr_mults or {})
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and "
                             "dampening = 0")
        if self._stateful_schedule():
            self.learningrate_schedule.reset(self.learningrate)

    def _stateful_schedule(self) -> bool:
        return bool(getattr(self.learningrate_schedule, "stateful", False))

    def _lr(self, step, state=None) -> float:
        if self._stateful_schedule() and state is not None \
                and "clr" in state:
            return state["clr"]
        if self.learningrate_schedule is not None:
            return float(self.learningrate_schedule(self.learningrate, step))
        return decayed_lr(self.learningrate, self.learningrate_decay, step)

    def get_learning_rate(self, step: int) -> float:
        if self._stateful_schedule():
            return float(self.learningrate_schedule.current_lr)
        return self._lr(step)

    def init_state(self, params):
        state = {}
        if self.momentum > 0:
            state["v"] = _zeros(params)
        if self._stateful_schedule():
            state["clr"] = float(self.learningrate)
        return state

    def hyper(self, step, state):
        return [self._lr(step, state)]

    def _mults(self, params) -> list:
        out = []
        for name in leaf_names(params):
            key = keystr(name)
            out.append(next((m for pat, m in self.layer_lr_mults.items()
                             if pat in key), 1.0))
        return out

    def update_with(self, params, grads, state, h):
        lr = h[0]
        wd, mu, damp = self.weightdecay, self.momentum, self.dampening
        mults = (self._mults(params) if self.layer_lr_mults
                 else [1.0] * len(leaves(params)))
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves(params), leaves(grads))):
                if wd > 0:
                    g = g + wd * p
                if mu > 0:
                    v = state["v"][i]
                    v.mul_(mu).add_(g, alpha=1.0 - damp)
                    g = g + mu * v if self.nesterov else v
                p.addcmul_(g, lr, value=-mults[i])


class Adam(OptimMethod):
    """Adam with the reference's default decayed learning rate."""

    elementwise_update = True

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def get_learning_rate(self, step: int) -> float:
        return decayed_lr(self.learningrate, self.learningrate_decay, step)

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def hyper(self, step, state):
        # lr / bc1 and bc2, the bias corrections at t = step + 1
        t = step + 1
        return [self.get_learning_rate(step) / (1.0 - self.beta1 ** t),
                1.0 - self.beta2 ** t]

    def update_with(self, params, grads, state, h):
        lr_bc1, bc2 = h[0], h[1]
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        with torch.no_grad():
            for p, g, m, v in zip(leaves(params), leaves(grads), state["m"],
                                  state["v"]):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                # p - lr · (m / bc1) / (sqrt(v / bc2) + eps)
                denom = (v / bc2).sqrt_().add_(eps)
                p.addcdiv_(m * lr_bc1, denom, value=-1.0)


class AdamW(Adam):
    """Adam with decoupled weight decay: after the Adam step,
    ``p -= lr · weightdecay · p_before``."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weightdecay: float = 1e-2):
        super().__init__(learningrate, learningrate_decay, beta1, beta2,
                         epsilon)
        self.weightdecay = weightdecay

    def hyper(self, step, state):
        return super().hyper(step, state) + [
            self.get_learning_rate(step) * self.weightdecay]

    def update_with(self, params, grads, state, h):
        if not self.weightdecay:
            return super().update_with(params, grads, state, h)
        with torch.no_grad():
            decay = [p * h[2] for p in leaves(params)]
        super().update_with(params, grads, state, h)
        with torch.no_grad():
            for p, d in zip(leaves(params), decay):
                p.sub_(d)


class Adagrad(OptimMethod):
    """``accum += g²; p -= clr · g / (√accum + 1e-10)`` with the default
    decayed ``clr``."""

    elementwise_update = True

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0):
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay

    def get_learning_rate(self, step: int) -> float:
        return decayed_lr(self.learningrate, self.learningrate_decay, step)

    def init_state(self, params):
        return {"accum": _zeros(params)}

    def hyper(self, step, state):
        return [self.get_learning_rate(step)]

    def update_with(self, params, grads, state, h):
        clr = h[0]
        with torch.no_grad():
            for p, g, a in zip(leaves(params), leaves(grads),
                               state["accum"]):
                if self.weightdecay > 0:
                    g = g + self.weightdecay * p
                a.addcmul_(g, g)
                p.addcdiv_(g * clr, a.sqrt().add_(1e-10), value=-1.0)


class Adadelta(OptimMethod):
    """Adadelta with an ``lr`` scale (the reference uses 1)."""

    elementwise_update = True

    def __init__(self, decayrate: float = 0.9, epsilon: float = 1e-10,
                 learningrate: float = 1.0):
        self.decayrate = decayrate
        self.epsilon = epsilon
        self.learningrate = learningrate

    def get_learning_rate(self, step: int) -> float:
        return float(self.learningrate)

    def init_state(self, params):
        return {"sq_avg": _zeros(params), "acc_delta": _zeros(params)}

    def update_with(self, params, grads, state, h):
        rho, eps, lr = self.decayrate, self.epsilon, self.learningrate
        with torch.no_grad():
            for p, g, s, a in zip(leaves(params), leaves(grads),
                                  state["sq_avg"], state["acc_delta"]):
                s.mul_(rho).addcmul_(g, g, value=1.0 - rho)
                delta = g * (a + eps).sqrt_() / (s + eps).sqrt_()
                a.mul_(rho).addcmul_(delta, delta, value=1.0 - rho)
                p.sub_(delta, alpha=lr)


class Adamax(OptimMethod):
    """``u = max(β₂·u, |g|); p -= (lr / (1-β₁ᵗ)) · m / (u + ε)``."""

    elementwise_update = True

    def __init__(self, learningrate: float = 0.002, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        self.learningrate = learningrate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def get_learning_rate(self, step: int) -> float:
        return float(self.learningrate)

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def hyper(self, step, state):
        return [self.learningrate / (1.0 - self.beta1 ** (step + 1))]

    def update_with(self, params, grads, state, h):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        clr = h[0]
        with torch.no_grad():
            for p, g, m, u in zip(leaves(params), leaves(grads), state["m"],
                                  state["u"]):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                torch.maximum(u.mul_(b2), g.abs(), out=u)
                p.addcdiv_(m * clr, u + eps, value=-1.0)


class RMSprop(OptimMethod):
    """``sa = ρ·sa + (1-ρ)·g²; p -= clr · g / (√sa + ε)``."""

    elementwise_update = True

    def __init__(self, learningrate: float = 1e-2,
                 learningrate_decay: float = 0.0, decayrate: float = 0.99,
                 epsilon: float = 1e-8):
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.decayrate = decayrate
        self.epsilon = epsilon

    def get_learning_rate(self, step: int) -> float:
        return decayed_lr(self.learningrate, self.learningrate_decay, step)

    def init_state(self, params):
        return {"sq_avg": _zeros(params)}

    def hyper(self, step, state):
        return [self.get_learning_rate(step)]

    def update_with(self, params, grads, state, h):
        clr = h[0]
        rho, eps = self.decayrate, self.epsilon
        with torch.no_grad():
            for p, g, s in zip(leaves(params), leaves(grads),
                               state["sq_avg"]):
                s.mul_(rho).addcmul_(g, g, value=1.0 - rho)
                p.addcdiv_(g * clr, s.sqrt().add_(eps), value=-1.0)


class Ftrl(OptimMethod):
    """FTRL-proximal, TensorFlow-style, with L1/L2 regularization and
    optional L2 shrinkage."""

    elementwise_update = True

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0):
        if initial_accumulator_value < 0:
            raise ValueError("initial_accumulator_value must be >= 0")
        if learningrate_power > 0:
            raise ValueError("learningrate_power must be <= 0")
        self.learningrate = learningrate
        self.learningrate_power = learningrate_power
        self.initial_accumulator_value = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def get_learning_rate(self, step: int) -> float:
        return float(self.learningrate)

    def init_state(self, params):
        return {"accum": [torch.full_like(p, self.initial_accumulator_value)
                          for p in leaves(params)],
                "linear": _zeros(params)}

    def update_with(self, params, grads, state, h):
        lr, lp = self.learningrate, self.learningrate_power
        with torch.no_grad():
            for p, g, n, z in zip(leaves(params), leaves(grads),
                                  state["accum"], state["linear"]):
                g_shrunk = g + 2.0 * self.l2_shrinkage * p
                new_n = n + g * g
                new_pow = new_n.pow(-lp)
                sigma = (new_pow - n.pow(-lp)) / lr
                z.add_(g_shrunk).sub_(sigma * p)
                quad = new_pow / lr + 2.0 * self.l2
                pre = z.clamp(-self.l1, self.l1) - z
                p.copy_(torch.where(z.abs() > self.l1, pre / quad,
                                    torch.zeros_like(p)))
                n.copy_(new_n)


class LarsSGD(OptimMethod):
    """Layer-wise adaptive rate scaling SGD. Per parameter leaf:
    ``local = trust · ‖w‖ / (‖g‖ + wd·‖w‖ + ε)`` (1 where either norm is 0),
    ``v = μ·v + clr·local·(g + wd·w); p -= v``. Per-leaf norms: never flat."""

    def __init__(self, learningrate: float = 1e-2,
                 learningrate_decay: float = 0.0, momentum: float = 0.9,
                 weightdecay: float = 0.0, trust: float = 1.0,
                 epsilon: float = 1e-9, learningrate_schedule=None):
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.momentum = momentum
        self.weightdecay = weightdecay
        self.trust = trust
        self.epsilon = epsilon
        if getattr(learningrate_schedule, "stateful", False):
            raise ValueError(
                "stateful schedules (Plateau) are only supported by SGD: "
                "LarsSGD carries no live-rate state, so the schedule would "
                "be inert")
        self.learningrate_schedule = learningrate_schedule

    def get_learning_rate(self, step: int) -> float:
        if self.learningrate_schedule is not None:
            return float(self.learningrate_schedule(self.learningrate, step))
        return decayed_lr(self.learningrate, self.learningrate_decay, step)

    def init_state(self, params):
        return {"v": _zeros(params)}

    def hyper(self, step, state):
        return [self.get_learning_rate(step)]

    def update_with(self, params, grads, state, h):
        clr = h[0]
        wd, mu, trust, eps = (self.weightdecay, self.momentum, self.trust,
                              self.epsilon)
        with torch.no_grad():
            for p, g, v in zip(leaves(params), leaves(grads), state["v"]):
                w_norm, g_norm = p.norm(), g.norm()
                local = torch.where(
                    (w_norm > 0) & (g_norm > 0),
                    trust * w_norm / (g_norm + wd * w_norm + eps),
                    torch.ones((), dtype=p.dtype, device=p.device))
                v.mul_(mu).add_((local * clr) * (g + wd * p))
                p.sub_(v)


class LBFGS(OptimMethod):
    """L-BFGS with a fixed history, one quasi-Newton iteration per
    ``update`` over all parameters flattened into one vector; no line
    search; step ``learningrate``, the first scaled by
    ``min(1, 1/‖g‖₁)``. As in JAX, the history bookkeeping (write slot,
    valid pairs, update count) lives on the device as 0-d tensors, and the
    two-loop recursion runs over every history slot with the invalid ones
    masked, so the update makes no host read."""

    def __init__(self, history: int = 8, learningrate: float = 1.0,
                 epsilon: float = 1e-10):
        self.history = history
        self.learningrate = learningrate
        self.epsilon = epsilon

    def get_learning_rate(self, step: int) -> float:
        return float(self.learningrate)

    @staticmethod
    def _flat(tree) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in leaves(tree)])

    def init_state(self, params):
        flat = self._flat(params)
        n, m = flat.numel(), self.history
        z = dict(dtype=flat.dtype, device=flat.device)

        def count():
            return torch.zeros((), dtype=torch.long, device=flat.device)

        return {"s": torch.zeros(m, n, **z), "y": torch.zeros(m, n, **z),
                "rho": torch.zeros(m, **z),
                "pos": count(),        # next write slot
                "hist_len": count(),   # valid pairs (<= m)
                "count": count(),      # update calls so far
                "prev_flat": torch.zeros(n, **z),
                "prev_grad": torch.zeros(n, **z)}

    def update_with(self, params, grads, state, h):
        m, eps = self.history, self.epsilon
        with torch.no_grad():
            flat, g = self._flat(params), self._flat(grads)
            S, Y, rho = state["s"], state["y"], state["rho"]
            pos, hist_len, count = (state["pos"], state["hist_len"],
                                    state["count"])
            zero = torch.zeros((), dtype=g.dtype, device=g.device)

            def row(mat, j):
                return mat.index_select(0, j.reshape(1))[0]

            # push last iteration's (s, y) pair if it passes the curvature
            # condition
            s_vec, y_vec = flat - state["prev_flat"], g - state["prev_grad"]
            ys = torch.dot(s_vec, y_vec)
            accept = (count > 0) & (ys > eps)
            at = pos.reshape(1)
            S.index_copy_(0, at, torch.where(accept, s_vec, row(S, pos))[None])
            Y.index_copy_(0, at, torch.where(accept, y_vec, row(Y, pos))[None])
            rho.index_copy_(0, at, torch.where(
                accept, 1.0 / ys.clamp(min=eps), row(rho, pos)).reshape(1))
            pos.copy_(torch.where(accept, (pos + 1) % m, pos))
            hist_len.copy_(torch.where(accept, (hist_len + 1).clamp(max=m),
                                       hist_len))
            newest = (pos - 1) % m      # valid only when hist_len > 0
            # two-loop recursion: newest to oldest, then oldest to newest
            q, alphas = g.clone(), []
            for i in range(m):
                j = (newest - i) % m
                a = torch.where(i < hist_len,
                                row(rho, j) * torch.dot(row(S, j), q), zero)
                q -= a * row(Y, j)
                alphas.append(a)
            y_new = row(Y, newest)
            gamma = torch.where(
                hist_len > 0,
                1.0 / (row(rho, newest) * torch.dot(y_new, y_new)
                       ).clamp(min=eps),
                zero + 1.0)
            r = gamma * q
            for k in reversed(range(m)):
                j = (newest - k) % m
                b = torch.where(k < hist_len,
                                row(rho, j) * torch.dot(row(Y, j), r), zero)
                r = r + torch.where(k < hist_len, alphas[k] - b, zero) \
                    * row(S, j)
            lr = torch.where(
                count == 0,
                (1.0 / g.abs().sum().clamp(min=eps)).clamp(max=1.0)
                * self.learningrate,
                zero + self.learningrate)
            state["prev_flat"].copy_(flat)
            state["prev_grad"].copy_(g)
            new_flat = flat - lr * r
            off = 0
            for p in leaves(params):
                n = p.numel()
                p.copy_(new_flat[off:off + n].view_as(p))
                off += n
            count.add_(1)


class CompositeOptimMethod(OptimMethod):
    """Per-submodule optimizers (reference ``setOptimMethods``): routes
    disjoint groups of parameters, found by module-path prefixes (tuples of
    child names), to their own method; parameters under no prefix use
    ``default``; the longest prefix wins. Built by
    ``Optimizer.set_optim_methods``. ``groups``: list of
    ``(name, path_prefix_tuple, method)``."""

    def __init__(self, groups, default: OptimMethod):
        self.groups = list(groups)
        self.default = default

    def _group_of(self, path: tuple) -> int:
        """Index into groups, or -1 for the default."""
        best, best_len = -1, -1
        for gi, (_, prefix, _) in enumerate(self.groups):
            if len(prefix) > best_len and path[:len(prefix)] == prefix:
                best, best_len = gi, len(prefix)
        return best

    def _partition(self, tree) -> list:
        parts = [dict() for _ in range(len(self.groups) + 1)]  # last: default
        for name, leaf in zip(leaf_names(tree), leaves(tree)):
            parts[self._group_of(tuple(name.split(".")))][name] = leaf
        return parts

    def _methods(self):
        keys = [f"g{gi}:{name}" for gi, (name, _, _) in enumerate(self.groups)]
        return list(zip(keys + ["default"],
                        [m for _, _, m in self.groups] + [self.default]))

    def init_state(self, params) -> dict:
        return {key: method.init_state(part) for (key, method), part
                in zip(self._methods(), self._partition(params))}

    def hyper(self, step, state):
        return [v for key, method in self._methods()
                for v in method.hyper(step, state[key])]

    def update_with(self, params, grads, state, h):
        off = 0
        for (key, method), p, g in zip(self._methods(),
                                       self._partition(params),
                                       self._partition(grads)):
            n = len(method.hyper(0, state[key]))
            method.update_with(p, g, state[key], h[off:off + n])
            off += n

    def get_learning_rate(self, step: int) -> float:
        return self.default.get_learning_rate(step)

    def __repr__(self):
        inner = ", ".join(f"{n}: {m!r}" for n, _, m in self.groups)
        return f"CompositeOptimMethod({inner}, default={self.default!r})"


__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "CompositeOptimMethod", "Ftrl", "LBFGS", "LarsSGD", "OptimMethod",
           "RMSprop", "SGD", "decayed_lr", "hyper_tensor", "keystr",
           "leaf_names", "leaves"]
