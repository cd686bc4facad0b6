"""The port's Keras API against the JAX package, on the CPU.

- every Keras layer of ``nn/keras/layers.py``: the JAX layer and the port's
  built with the same arguments at the same input shape, the JAX weights
  moved across by path (``convert.load_jax_params``), the same numpy input
  from a seed (batch 2 to 4, widths <= 8): ``compute_output_shape`` equal
  to both outputs' shape, outputs within 1e-5, and the gradients of
  ``sum(out * w)`` with respect to every parameter and the floating input
  within 1e-4 relative (Frobenius norm of the difference over JAX's). The
  random layers are compared in eval mode, batch norm in training mode;
- ``Sequential`` and the functional ``Model`` (``merge(mode="concat")``):
  ``compile``, ``fit`` for 3 steps (one batch an epoch, 3 epochs), the
  final loss within 1e-5 and the parameters within 1e-4 relative of JAX's,
  ``evaluate`` and ``predict``/``predict_classes`` equal; ``predict`` of a
  ``Model`` in every other merge mode equal to JAX's;
- a LeNet-5 ``Sequential`` fitted against the same model built from the
  port's ``nn`` with the same weights (the losses equal);
- ``fit(distributed=True)`` refused naming ROADMAP A.6; the shape checks;
- a name-by-name diff of ``bigdl_tpu/nn/keras/`` against the port, and the
  two packages' ``__all__``.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn import keras as JK
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.nn import keras as K
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_and_reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _compiled(fn, *args):
    """``fn(*args)`` as one compiled program, without XLA's expensive CPU
    passes (these tiny programs compile far longer than they run)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


# (id, layer factory given the Keras module, per-sample input shape,
#  training mode, integer ids below this bound instead of floats)
LAYERS = [
    ("Dense", lambda k: k.Dense(5, activation="tanh"), (6,), False, None),
    ("Dense-nobias", lambda k: k.Dense(4, bias=False), (6,), False, None),
    ("Activation", lambda k: k.Activation("softplus"), (3, 4), False, None),
    ("Dropout", lambda k: k.Dropout(0.3), (6,), False, None),
    ("Flatten", lambda k: k.Flatten(), (2, 3, 4), False, None),
    ("Reshape", lambda k: k.Reshape((4, 6)), (2, 3, 4), False, None),
    ("Conv2D-valid", lambda k: k.Convolution2D(3, 3, 3, activation="relu"),
     (2, 8, 8), False, None),
    ("Conv2D-same-strided", lambda k: k.Convolution2D(
        3, 3, 3, border_mode="same", subsample=(2, 2)), (2, 7, 7), False,
     None),
    ("Conv2D-same-even", lambda k: k.Convolution2D(
        2, 2, 4, border_mode="same"), (2, 6, 6), False, None),
    ("MaxPooling2D", lambda k: k.MaxPooling2D(), (3, 6, 6), False, None),
    ("AveragePooling2D-same", lambda k: k.AveragePooling2D(
        (3, 3), strides=(2, 2), border_mode="same"), (2, 7, 7), False, None),
    ("GlobalAveragePooling2D", lambda k: k.GlobalAveragePooling2D(),
     (3, 4, 5), False, None),
    ("GlobalMaxPooling2D", lambda k: k.GlobalMaxPooling2D(), (3, 4, 5),
     False, None),
    ("ZeroPadding2D", lambda k: k.ZeroPadding2D((1, 2)), (2, 4, 4), False,
     None),
    ("BatchNormalization-spatial", lambda k: k.BatchNormalization(),
     (3, 4, 4), True, None),
    ("BatchNormalization", lambda k: k.BatchNormalization(momentum=0.9),
     (6,), True, None),
    ("Embedding", lambda k: k.Embedding(10, 4), (5,), False, 10),
    ("LSTM", lambda k: k.LSTM(4), (5, 3), False, None),
    ("GRU-sequences", lambda k: k.GRU(4, return_sequences=True), (5, 3),
     False, None),
    ("SimpleRNN-backwards", lambda k: k.SimpleRNN(4, go_backwards=True),
     (5, 3), False, None),
    ("Convolution1D-same", lambda k: k.Convolution1D(
        4, 3, border_mode="same", subsample_length=2, activation="relu"),
     (9, 3), False, None),
    ("Convolution1D", lambda k: k.Convolution1D(4, 2), (6, 3), False, None),
    ("MaxPooling1D", lambda k: k.MaxPooling1D(2), (8, 3), False, None),
    ("AveragePooling1D", lambda k: k.AveragePooling1D(3, 2), (8, 3), False,
     None),
    ("GlobalMaxPooling1D", lambda k: k.GlobalMaxPooling1D(), (6, 3), False,
     None),
    ("GlobalAveragePooling1D", lambda k: k.GlobalAveragePooling1D(), (6, 3),
     False, None),
    ("LayerNormalization", lambda k: k.LayerNormalization(), (5, 6), False,
     None),
    ("Permute-2", lambda k: k.Permute((2, 1)), (3, 4), False, None),
    ("Permute-3", lambda k: k.Permute((3, 1, 2)), (2, 3, 4), False, None),
    ("RepeatVector", lambda k: k.RepeatVector(3), (4,), False, None),
    ("Masking", lambda k: k.Masking(0.0), (5, 3), False, None),
    ("Highway", lambda k: k.Highway(activation="relu"), (6,), False, None),
    ("MaxoutDense", lambda k: k.MaxoutDense(4, nb_feature=3), (6,), False,
     None),
    ("UpSampling1D", lambda k: k.UpSampling1D(2), (4, 3), False, None),
    ("UpSampling2D", lambda k: k.UpSampling2D((2, 3)), (2, 3, 3), False,
     None),
    ("UpSampling3D", lambda k: k.UpSampling3D((2, 1, 2)), (2, 2, 3, 3),
     False, None),
    ("ZeroPadding1D", lambda k: k.ZeroPadding1D(2), (4, 3), False, None),
    ("ZeroPadding3D", lambda k: k.ZeroPadding3D((1, 0, 2)), (2, 2, 3, 3),
     False, None),
    ("Cropping1D", lambda k: k.Cropping1D((1, 2)), (6, 3), False, None),
    ("Cropping2D", lambda k: k.Cropping2D(((1, 0), (0, 2))), (2, 5, 5),
     False, None),
    ("Cropping3D", lambda k: k.Cropping3D(((1, 0), (0, 1), (1, 1))),
     (2, 4, 5, 5), False, None),
    ("MaxPooling3D", lambda k: k.MaxPooling3D(), (2, 4, 4, 4), False, None),
    ("AveragePooling3D", lambda k: k.AveragePooling3D((2, 2, 1)),
     (2, 4, 4, 3), False, None),
    ("Convolution3D", lambda k: k.Convolution3D(3, 2, 2, 2,
                                                 activation="sigmoid"),
     (2, 4, 4, 4), False, None),
    ("Deconvolution2D", lambda k: k.Deconvolution2D(3, 3, 3,
                                                     subsample=(2, 2)),
     (2, 4, 4), False, None),
    ("AtrousConvolution2D", lambda k: k.AtrousConvolution2D(
        3, 3, 3, atrous_rate=(2, 2)), (2, 8, 8), False, None),
    ("SeparableConvolution2D", lambda k: k.SeparableConvolution2D(
        4, 3, 3, depth_multiplier=2, border_mode="same"), (2, 6, 6), False,
     None),
    ("LocallyConnected1D", lambda k: k.LocallyConnected1D(4, 3), (6, 3),
     False, None),
    ("LocallyConnected2D", lambda k: k.LocallyConnected2D(3, 2, 2),
     (2, 5, 5), False, None),
    ("SpatialDropout1D", lambda k: k.SpatialDropout1D(0.2), (4, 3), False,
     None),
    ("SpatialDropout2D", lambda k: k.SpatialDropout2D(0.2), (2, 4, 4),
     False, None),
    ("SpatialDropout3D", lambda k: k.SpatialDropout3D(0.2), (2, 3, 3, 3),
     False, None),
    ("GaussianDropout", lambda k: k.GaussianDropout(0.3), (6,), False, None),
    ("GaussianNoise", lambda k: k.GaussianNoise(0.2), (6,), False, None),
    ("LeakyReLU", lambda k: k.LeakyReLU(0.2), (6,), False, None),
    ("ELU", lambda k: k.ELU(0.7), (6,), False, None),
    ("ThresholdedReLU", lambda k: k.ThresholdedReLU(0.5), (6,), False,
     None),
    ("PReLU-features", lambda k: k.PReLU(), (6,), False, None),
    ("PReLU-channels", lambda k: k.PReLU(), (2, 3, 3), False, None),
    ("PReLU-temporal", lambda k: k.PReLU(), (4, 3), False, None),
    ("TimeDistributed", lambda k: k.TimeDistributed(k.Dense(4)), (5, 3),
     False, None),
    ("Bidirectional-concat", lambda k: k.Bidirectional(k.LSTM(3)), (5, 4),
     False, None),
    ("Bidirectional-sum-sequences", lambda k: k.Bidirectional(
        k.GRU(3, return_sequences=True), merge_mode="sum"), (5, 4), False,
     None),
    ("SReLU", lambda k: k.SReLU(), (3, 4), False, None),
    ("SReLU-shared", lambda k: k.SReLU(shared_axes=[1]), (3, 4), False,
     None),
    ("GlobalAveragePooling3D", lambda k: k.GlobalAveragePooling3D(),
     (2, 3, 4, 4), False, None),
    ("GlobalMaxPooling3D", lambda k: k.GlobalMaxPooling3D(), (2, 3, 4, 4),
     False, None),
    ("ConvLSTM2D", lambda k: k.ConvLSTM2D(3, 3), (3, 2, 5, 5), False, None),
    ("ConvLSTM2D-sequences", lambda k: k.ConvLSTM2D(
        2, 3, return_sequences=True, go_backwards=True), (3, 2, 4, 4),
     False, None),
]


def _perturbed(tree, seed=5):
    """JAX's params with a small draw added: a degenerate init (SReLU's
    zeros, a gate's constant bias) would hide a wrong path."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(a) + 0.1 * rng.normal(size=np.shape(a))
                    .astype(np.float32)) for a in leaves])


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_keras_layer_matches_jax(case):
    _, make, shape, training, id_bound = case
    JaxRNG.set_seed(3)
    jl, tl = make(JK), make(K)
    jm, tm = jl.build(shape), tl.build(shape)
    out_shape = jl.compute_output_shape(shape)
    assert tuple(tl.compute_output_shape(shape)) == tuple(out_shape)
    params = _perturbed(jm.get_params())
    load_jax_params(tm, jax.device_get(params))
    tm.train(training)
    batch = 4 if training else 2
    if id_bound is not None:
        x = np.random.default_rng(1).integers(
            0, id_bound, size=(batch,) + shape).astype(np.int32)
    else:
        x = _x(batch, *shape, seed=1)
    w = _x(batch, *out_shape, seed=2)

    def jloss(p, xx):
        out = jm.apply(p, jm.get_state(), xx, training=training)[0]
        return (out * w).sum(), out

    if id_bound is None:
        (_, want), (gp, gx) = _compiled(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True), params, jnp.asarray(x))
    else:
        (_, want), gp = _compiled(jax.value_and_grad(
            jloss, has_aux=True), params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    if id_bound is None:
        xt.requires_grad_()
    got = tm(xt)
    assert tuple(got.shape) == (batch,) + tuple(out_shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    gp = flatten_tree(jax.device_get(gp))
    assert sorted(gp) == sorted(n for n, _ in tm.named_parameters())
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), gp[n]) <= 1e-4, n
    if id_bound is None:
        assert _rel(xt.grad.numpy(), gx) <= 1e-4


def test_merge_layer_with_branches_matches_jax():
    JaxRNG.set_seed(3)

    def make(k):
        return k.Merge(layers=[k.Dense(4, input_shape=(3,)),
                               k.Dense(4, input_shape=(5,))], mode="concat")

    jl, tl = make(JK), make(K)
    jm = jl.build(jl.input_shape)
    tm = tl.build(tl.input_shape)
    assert tl.compute_output_shape(tl.input_shape) == (8,)
    load_jax_params(tm, jax.device_get(jm.get_params()))
    a, b = _x(2, 3, seed=1), _x(2, 5, seed=2)
    from bigdl_tpu.utils.table import T as JT
    from bigdl_tpu_torch.utils.table import T
    want = jm.apply(jm.get_params(), jm.get_state(),
                    JT(jnp.asarray(a), jnp.asarray(b)))[0]
    got = tm(T(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- the topologies
def _blobs(n, d=6, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = (rng.normal(size=(n, d)) + y[:, None]).astype(np.float32)
    return x, y


def _same_weights(jmodel, tmodel):
    load_jax_params(tmodel._module(),
                    jax.device_get(jmodel._module().get_params()))


def _fit_both(jmodel, tmodel, x, y, optimizer, loss, metrics=None):
    """Compile both, fit 3 steps (one batch an epoch, 3 epochs) from the
    same weights and the same shuffle seed."""
    _same_weights(jmodel, tmodel)
    jmodel.compile(optimizer, loss, metrics)
    tmodel.compile(optimizer, loss, metrics)
    JaxRNG.set_seed(7)
    RandomGenerator.set_seed(7)
    n = len(x[0]) if isinstance(x, list) else len(x)
    jmodel.fit(x, y, batch_size=n, nb_epoch=3)
    tmodel.fit(x, y, batch_size=n, nb_epoch=3)
    jopt, topt = jmodel._last_optimizer, tmodel._last_optimizer
    assert topt.state["neval"] - 1 == 3
    assert topt.state["loss"] == pytest.approx(jopt.state["loss"],
                                               rel=1e-5, abs=1e-5)
    want = flatten_tree(jax.device_get(jmodel._module().get_params()))
    for n_, p in tmodel._module().named_parameters():
        assert _rel(p.detach().numpy(), want[n_]) <= 1e-4, n_


def test_sequential_compile_fit_evaluate_predict_match_jax():
    x, y = _blobs(32)
    JaxRNG.set_seed(2)
    models = []
    for k, kw in ((JK, {}), (K, {"device": "cpu"})):
        m = k.Sequential(**kw)
        m.add(k.Dense(8, activation="relu", input_shape=(6,)))
        m.add(k.Dropout(0.0))
        m.add(k.Dense(3, activation="softmax"))
        models.append(m)
    jm, tm = models
    assert tm.output_shape == jm.output_shape == (3,)
    _fit_both(jm, tm, x, y, "adam", "sparse_categorical_crossentropy",
              ["accuracy"])
    assert tm.evaluate(x, y, batch_size=16) == pytest.approx(
        jm.evaluate(x, y, batch_size=16))
    np.testing.assert_allclose(tm.predict(x, batch_size=16),
                               np.asarray(jm.predict(x, batch_size=16)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tm.predict_classes(x, batch_size=16),
                                  jm.predict_classes(x, batch_size=16))
    with pytest.raises(ValueError, match="per-sample input shape"):
        tm.predict(x[:, :4])


@pytest.mark.parametrize("mode", ["concat", "sum", "mul", "ave", "max",
                                  "dot", "cos"])
def test_functional_model_with_merge_matches_jax(mode):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(16, 5)).astype(np.float32)
    b = rng.normal(size=(16, 4)).astype(np.float32)
    y = rng.normal(size=(16, 2)).astype(np.float32)
    JaxRNG.set_seed(2)
    models = []
    for k, kw in ((JK, {}), (K, {"device": "cpu"})):
        ia, ib = k.Input((5,)), k.Input((4,))
        merged = k.merge([k.Dense(3, activation="tanh")(ia),
                          k.Dense(3, activation="tanh")(ib)], mode=mode)
        models.append(k.Model([ia, ib], k.Dense(2)(merged), **kw))
    jm, tm = models
    assert tm.output_shape == jm.output_shape == (2,)
    _same_weights(jm, tm)
    if mode == "concat":
        # the fit path does not depend on the mode: once is enough
        _fit_both(jm, tm, [a, b], y, "sgd", "mse", ["mae"])
        assert tm.evaluate([a, b], y, batch_size=8) == pytest.approx(
            jm.evaluate([a, b], y, batch_size=8), rel=1e-5)
    np.testing.assert_allclose(tm.predict([a, b], batch_size=8),
                               np.asarray(jm.predict([a, b], batch_size=8)),
                               rtol=1e-5, atol=1e-6)


def lenet_layers(k):
    return [k.Convolution2D(6, 5, 5, activation="tanh",
                            input_shape=(1, 28, 28)),
            k.MaxPooling2D(), k.Convolution2D(12, 5, 5, activation="tanh"),
            k.MaxPooling2D(), k.Flatten(), k.Dense(100, activation="tanh"),
            k.Dense(10, activation="log_softmax")]


def test_keras_lenet_fit_equals_the_nn_model_with_the_same_weights():
    """The Keras LeNet-5 and the same stack of the port's ``nn`` layers,
    one set of weights, 2 epochs of Adam through ``LocalOptimizer``: the
    same losses and parameters, bit for bit."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    torch.manual_seed(0)
    km = K.Sequential(device="cpu")
    for layer in lenet_layers(K):
        km.add(layer)
    ref = (nn.Sequential()
           .add(nn.Sequential().add(nn.SpatialConvolution(1, 6, 5, 5))
                .add(nn.Tanh()))
           .add(nn.SpatialMaxPooling(2, 2, 2, 2, 0, 0))
           .add(nn.Sequential().add(nn.SpatialConvolution(6, 12, 5, 5))
                .add(nn.Tanh()))
           .add(nn.SpatialMaxPooling(2, 2, 2, 2, 0, 0))
           .add(nn.Reshape([192]))
           .add(nn.Sequential().add(nn.Linear(192, 100)).add(nn.Tanh()))
           .add(nn.Sequential().add(nn.Linear(100, 10))
                .add(nn.LogSoftMax())))
    ref.load_state_dict(km._module().state_dict())
    km.compile("adam", nn.ClassNLLCriterion())
    RandomGenerator.set_seed(1)
    km.fit(x, y, batch_size=8, nb_epoch=2)
    RandomGenerator.set_seed(1)
    data = (DataSet.array([Sample(a, b) for a, b in zip(x, y)])
            >> SampleToMiniBatch(8))
    opt = (optim.LocalOptimizer(ref, data, nn.ClassNLLCriterion(),
                                device="cpu")
           .set_optim_method(optim.Adam())
           .set_end_when(optim.Trigger.max_epoch(2)))
    opt.optimize()
    assert km._last_optimizer.state["loss"] == opt.state["loss"]
    for (n, p), (_, q) in zip(km._module().named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(p, q), n


def test_fit_refuses_distributed_and_needs_compile():
    m = K.Sequential(device="cpu")
    m.add(K.Dense(2, input_shape=(3,)))
    x, y = np.ones((4, 3), np.float32), np.zeros(4, np.int32)
    with pytest.raises(RuntimeError, match="compile"):
        m.fit(x, y)
    m.compile("sgd", "mse")
    # fit(distributed=True) trains through DistriOptimizer: world 1 here
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.init(backend="cpu")
    try:
        m.fit(x, np.zeros((4, 2), np.float32), batch_size=4, nb_epoch=1,
              distributed=True)
        assert isinstance(m._last_optimizer, DistriOptimizer)
        assert np.isfinite(m._last_optimizer.state["loss"])
    finally:
        Engine.reset()
    with pytest.raises(ValueError, match="first layer must declare"):
        K.Sequential().add(K.Dense(2))


# ---------------------------------------------------------- the name diff
def _defined(path) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))
            and not n.name.startswith("_")}


def test_every_public_definition_of_keras_is_ported():
    for f in ("layers", "topology"):
        want = _defined(os.path.join(ROOT, "bigdl_tpu", "nn", "keras",
                                     f + ".py"))
        got = _defined(os.path.join(ROOT, "bigdl_tpu_torch", "nn", "keras",
                                    f + ".py"))
        assert sorted(want - got) == [], f
    assert sorted(K.__all__) == sorted(JK.__all__)
    assert all(hasattr(K, n) for n in K.__all__)
