"""The fused LM head of the port against the JAX package, on the CPU:
``chunked_softmax_xent`` (forward and its recomputing backward),
``FusedLMHead`` and ``ChunkedSoftmaxCrossEntropy``.

Inputs are made with numpy from a seed; V = 50 or 61 with chunks that do
not divide it, labels include ignored (negative) and out-of-range (>= V)
ones. Tolerances: the loss and every gradient (dh, dW, db) within 1e-5
relative, as the norm of the difference over the norm of JAX's: the port
forms the target's one-hot term inside its chunk where JAX scatter-adds it
afterwards, the same sums in another order. bf16 inputs within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.fused_loss import chunked_softmax_xent as jax_xent
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.nn.fused_loss import chunked_softmax_xent

N, D = 24, 8


def _inputs(v, seed=0):
    r = np.random.default_rng(seed)
    h = r.normal(size=(N, D)).astype(np.float32)
    w = (r.normal(size=(v, D)) * 0.5).astype(np.float32)
    b = (r.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = r.integers(0, v, N).astype(np.int32)
    labels[[2, 7]] = -1              # ignored
    labels[[5, 11]] = [v, v + 3]     # out of range: masked alike
    g = r.uniform(0.5, 1.5, N).astype(np.float32)
    return h, w, b, labels, g


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_xent(h, w, b, labels, g, chunk, dtype):
    args = [jnp.asarray(h).astype(dtype), jnp.asarray(w).astype(dtype),
            None if b is None else jnp.asarray(b).astype(dtype)]
    loss, vjp = jax.vjp(lambda h_, w_, b_: jax_xent(
        h_, w_, b_, jnp.asarray(labels), chunk), *args)
    return loss, vjp(jnp.asarray(g))


def _torch_xent(h, w, b, labels, g, chunk, dtype):
    args = [torch.tensor(h).to(dtype).requires_grad_(),
            torch.tensor(w).to(dtype).requires_grad_(),
            None if b is None else torch.tensor(b).to(dtype)
            .requires_grad_()]
    loss = chunked_softmax_xent(args[0], args[1], args[2],
                                torch.tensor(labels), chunk)
    grads = torch.autograd.grad(loss, [a for a in args if a is not None],
                                torch.tensor(g))
    return loss, grads


@pytest.mark.parametrize("v,chunk", [(50, 16), (61, 24), (50, 50),
                                     (50, 8192)])
@pytest.mark.parametrize("bias", [True, False])
def test_chunked_softmax_xent_matches_jax(v, chunk, bias):
    h, w, b, labels, g = _inputs(v)
    b = b if bias else None
    want_loss, want_grads = _jax_xent(h, w, b, labels, g, chunk,
                                      jnp.float32)
    loss, grads = _torch_xent(h, w, b, labels, g, chunk, torch.float32)
    assert loss.dtype == torch.float32
    assert _rel(loss.detach(), want_loss) < 1e-5
    ignored = (labels < 0) | (labels >= v)
    assert np.all(loss.detach().numpy()[ignored] == 0.0)
    for name, got, want in zip(("dh", "dW", "db"), grads, want_grads):
        assert got.dtype == torch.float32
        assert _rel(got, want) < 1e-5, name


def test_chunked_softmax_xent_matches_jax_in_bf16():
    h, w, b, labels, g = _inputs(61, seed=1)
    want_loss, want_grads = _jax_xent(h, w, b, labels, g, 24, jnp.bfloat16)
    loss, grads = _torch_xent(h, w, b, labels, g, 24, torch.bfloat16)
    assert loss.dtype == torch.float32           # fp32 chunks, as JAX's
    np.testing.assert_allclose(loss.detach().numpy(),
                               np.asarray(want_loss), rtol=2e-2, atol=2e-2)
    for name, got, want in zip(("dh", "dW", "db"), grads, want_grads):
        assert got.dtype == torch.bfloat16, name  # the inputs' dtypes
        assert str(want.dtype) == "bfloat16"
        assert _rel(got.float(), np.asarray(want, np.float32)) < 2e-2, name


class _Shapes(TorchDispatchMode):
    """Records the element count of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_no_tokens_by_vocab_tensor_exists_in_either_pass():
    """Neither pass makes an (N, V) tensor: the largest tensor of the
    forward and the backward is the (V, d) weight gradient or an (N,
    chunk) block."""
    v, chunk = 50, 16
    h, w, b, labels, g = _inputs(v)
    with _Shapes() as rec:
        loss, grads = _torch_xent(h, w, b, labels, g, chunk, torch.float32)
    assert rec.largest == max(v * D, N * chunk) < N * v


def test_backward_repeats_bit_for_bit():
    h, w, b, labels, g = _inputs(61, seed=2)
    first = _torch_xent(h, w, b, labels, g, 24, torch.float32)[1]
    second = _torch_xent(h, w, b, labels, g, 24, torch.float32)[1]
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def _head_pair(v=50, bias=True, log_probs=True):
    JaxRNG.set_seed(3)
    jm = jnn.FusedLMHead(D, v, with_bias=bias, eval_log_probs=log_probs)
    tm = tnn.FusedLMHead(D, v, with_bias=bias, eval_log_probs=log_probs)
    p = dict(jm.get_params())
    if bias:      # a non-zero bias, so the eval head tests it
        p["bias"] = jnp.asarray(np.random.default_rng(4).normal(size=v)
                                .astype(np.float32))
    load_jax_params(tm, {k: np.asarray(a) for k, a in p.items()})
    return jm, p, tm


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("log_probs", [True, False])
def test_fused_lm_head_matches_jax(bias, log_probs):
    jm, p, tm = _head_pair(bias=bias, log_probs=log_probs)
    x = np.random.default_rng(5).normal(size=(2, 7, D)).astype(np.float32)
    # eval: logits or log-probs
    want = jm.apply(p, {}, jnp.asarray(x), training=False)[0]
    got = tm.evaluate().forward(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # training: Table(hidden, weight[, bias])
    jt = jm.apply(p, {}, jnp.asarray(x), training=True)[0]
    tt = tm.train().forward(torch.from_numpy(x))
    assert len(tt) == len(jt) == (3 if bias else 2)
    for a, c in zip(tt.values(), jt.values()):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(c))
    ids = np.array([[0, 3, 49]])
    np.testing.assert_array_equal(
        tm.embed(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm.embed(p, jnp.asarray(ids))))


@pytest.mark.parametrize("zero_based", [True, False])
def test_chunked_criterion_matches_jax(zero_based):
    """The mean NLL over valid tokens and its gradients through the head's
    Table, 1-based labels shifted as JAX shifts them."""
    jm, p, tm = _head_pair()
    r = np.random.default_rng(6)
    x = r.normal(size=(2, 12, D)).astype(np.float32)
    y = r.integers(0, 50, (2, 12)).astype(np.int32)
    y[0, 3] = -5
    y[1, 7] = 50
    if not zero_based:
        y = y + 1
    jcrit = jnn.ChunkedSoftmaxCrossEntropy(chunk_size=16,
                                           zero_based=zero_based)

    def jloss(params):
        out = jm.apply(params, {}, jnp.asarray(x), training=True)[0]
        return jcrit.apply(out, jnp.asarray(y))

    want, want_g = jax.value_and_grad(jloss)(p)
    crit = tnn.ChunkedSoftmaxCrossEntropy(chunk_size=16,
                                          zero_based=zero_based)
    loss = crit(tm.train().forward(torch.from_numpy(x)), torch.from_numpy(y))
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    names, params = zip(*tm.named_parameters())
    for n, g in zip(names, torch.autograd.grad(loss, params)):
        assert _rel(g, want_g[n]) < 1e-5, n
