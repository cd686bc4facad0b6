"""Keras-style model topologies: ``Sequential`` and the functional
``Model`` with ``compile`` / ``fit`` / ``evaluate`` / ``predict``.

Counterpart of ``bigdl_tpu/nn/keras/topology.py``: ``compile(optimizer,
loss, metrics)`` resolves Keras names to the port's methods, criteria and
validation methods; ``fit`` runs the port's ``LocalOptimizer`` (numpy in:
one ``Sample`` a row, batched by ``SampleToMiniBatch``), ``evaluate`` its
``Evaluator`` and ``predict`` its ``Predictor``. A model lives on its
``device`` (None: the card), where its module is moved at the first of
these calls. ``fit(..., distributed=True)`` trains through
``DistriOptimizer`` over the Engine mesh (one process a rank), on this
rank's device when ``device`` is None, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import nn as N
from bigdl_tpu_torch.nn.graph import Input as GraphInput, ModuleNode
from bigdl_tpu_torch.nn.keras.layers import KerasLayer
from bigdl_tpu_torch.utils.device import resolve_device


class KerasNode:
    """Functional-API handle: a graph node plus its (batch-less) activation shape."""

    def __init__(self, node: ModuleNode, shape: tuple):
        self.node = node
        self.shape = tuple(shape)

    def __repr__(self):
        return f"KerasNode(shape={self.shape})"


def Input(shape: Sequence[int], name: Optional[str] = None) -> KerasNode:
    """Functional-API entry point: a placeholder carrying the declared shape."""
    return KerasNode(GraphInput(), tuple(shape))


def _merge_module(mode: str, shapes, concat_axis: int = 1):
    """(module, merged shape) for a merge over inputs with the given batch-
    free shapes — shared by the functional ``merge`` and the ``Merge``
    layer class."""
    shapes = [tuple(s) for s in shapes]
    if mode == "concat":
        for s in shapes[1:]:
            if len(s) != len(shapes[0]):
                raise ValueError(f"rank mismatch in concat merge: {shapes}")
        rank = len(shapes[0])
        # concat_axis counts the batch dim (Keras convention); normalize negatives
        axis0 = (rank + concat_axis) if concat_axis < 0 else concat_axis - 1
        if not 0 <= axis0 < rank:
            raise ValueError(f"concat_axis {concat_axis} out of range for rank "
                             f"{rank}+batch shapes {shapes}")
        out = list(shapes[0])
        out[axis0] = sum(s[axis0] for s in shapes)
        return N.JoinTable(axis0 + 2), tuple(out)  # 1-based dim incl. batch
    if mode in ("sum", "add"):
        return N.CAddTable(), shapes[0]
    if mode == "mul":
        return N.CMulTable(), shapes[0]
    if mode == "ave":
        return N.CAveTable(), shapes[0]
    if mode == "max":
        return N.CMaxTable(), shapes[0]
    if mode == "dot":
        if len(shapes) != 2:
            raise ValueError("dot merge takes exactly two inputs")
        return N.Sequential().add(N.DotProduct()).add(N.Unsqueeze(2)), (1,)
    if mode == "cos":
        if len(shapes) != 2:
            raise ValueError("cos merge takes exactly two inputs")
        return N.Sequential().add(N.CosineDistance()).add(N.Unsqueeze(2)), (1,)
    raise ValueError(f"unknown merge mode {mode!r} "
                     f"(concat|sum|mul|ave|max|dot|cos)")


def merge_nodes(nodes, mode: str = "concat", concat_axis: int = 1) -> KerasNode:
    """Merge several functional nodes (reference keras ``Merge``/``merge``)."""
    from bigdl_tpu_torch.nn.graph import make_node
    nodes = list(nodes)
    module, shape = _merge_module(mode, [n.shape for n in nodes], concat_axis)
    return KerasNode(make_node(module, [n.node for n in nodes]), shape)


merge = merge_nodes


# ---------------------------------------------------------------- loss/optim maps
def _prob_crossentropy():
    """Keras categorical_crossentropy: model outputs *probabilities* (softmax last
    layer); ClassNLLCriterion takes the log itself with logprob_as_input=False."""
    return N.ClassNLLCriterion(logprob_as_input=False)


def _resolve_loss(loss):
    if not isinstance(loss, str):
        return loss
    table = {
        "categorical_crossentropy": _prob_crossentropy,
        "sparse_categorical_crossentropy": _prob_crossentropy,
        "mse": N.MSECriterion, "mean_squared_error": N.MSECriterion,
        "mae": N.AbsCriterion, "mean_absolute_error": N.AbsCriterion,
        "binary_crossentropy": N.BCECriterion,
        "hinge": N.MarginCriterion,
    }
    if loss not in table:
        raise ValueError(f"unknown loss {loss!r}")
    return table[loss]()


def _resolve_optimizer(opt):
    if not isinstance(opt, str):
        return opt
    from bigdl_tpu_torch import optim as O
    table = {
        "sgd": lambda: O.SGD(learningrate=0.01),
        "adam": lambda: O.Adam(),
        "adamax": lambda: O.Adamax(),
        "adagrad": lambda: O.Adagrad(),
        "adadelta": lambda: O.Adadelta(),
        "rmsprop": lambda: O.RMSprop(),
    }
    if opt not in table:
        raise ValueError(f"unknown optimizer {opt!r}")
    return table[opt]()


def _resolve_metric(m):
    if not isinstance(m, str):
        return m
    from bigdl_tpu_torch import optim as O
    table = {"accuracy": O.Top1Accuracy, "acc": O.Top1Accuracy,
             "top5": O.Top5Accuracy, "loss": O.Loss, "mae": O.MAE}
    if m not in table:
        raise ValueError(f"unknown metric {m!r}")
    return table[m]()


class KerasModel:
    """Shared compile/fit/evaluate/predict over an underlying nn module,
    which lives on ``device`` (None: the card)."""

    def __init__(self, device=None):
        self._optim_method = None
        self._criterion = None
        self._metrics = None
        self.device = device

    # subclasses provide the built nn module
    def _module(self) -> torch.nn.Module:
        raise NotImplementedError

    def _placed(self) -> torch.nn.Module:
        """The module, moved to the model's device (parameters in place)."""
        return self._module().to(resolve_device(self.device))

    def _input_shape(self) -> Optional[tuple]:
        """Declared per-sample input shape, when known (Sequential only)."""
        return None

    def _check_input(self, x) -> None:
        want = self._input_shape()
        if want is None or not isinstance(x, np.ndarray):
            return
        if tuple(x.shape[1:]) != tuple(want):
            raise ValueError(
                f"model expects per-sample input shape {tuple(want)}, got "
                f"{tuple(x.shape[1:])} (full array shape {x.shape}); reshape your "
                "data — e.g. images need an explicit channel axis")

    def compile(self, optimizer, loss, metrics=None) -> "KerasModel":
        self._optim_method = _resolve_optimizer(optimizer)
        self._criterion = _resolve_loss(loss)
        self._metrics = [_resolve_metric(m) for m in (metrics or [])]
        return self

    def _classification(self) -> bool:
        return isinstance(self._criterion,
                          (N.ClassNLLCriterion, N.CrossEntropyCriterion))

    def _to_samples(self, x, y):
        from bigdl_tpu_torch.dataset.sample import Sample
        if isinstance(x, (list, tuple)):
            # functional multi-input model: one array per Input node → each
            # Sample carries a tuple feature (MiniBatch stacks per input)
            xs = [np.asarray(xi) for xi in x]
            xs = [xi.astype(np.float32)
                  if not np.issubdtype(xi.dtype, np.floating) else xi
                  for xi in xs]
            if len({len(xi) for xi in xs}) != 1:
                raise ValueError("multi-input arrays disagree on n_samples")
            if y is None:
                return [Sample(tuple(row)) for row in zip(*xs)]
            y = np.asarray(y)
            if self._classification() and y.ndim == 2 and y.shape[1] > 1:
                y = y.argmax(axis=1)
            y = y.astype(np.int32) if np.issubdtype(y.dtype, np.integer) \
                else y.astype(np.float32)
            return [Sample(tuple(row), yi) for *row, yi
                    in zip(*xs, y)]
        x = np.asarray(x)
        if not np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float32)
        if y is None:
            return [Sample(xi) for xi in x]
        y = np.asarray(y)
        # one-hot → int labels, but ONLY for classification losses — 2-D float
        # regression / multi-label targets must pass through untouched
        if self._classification() and y.ndim == 2 and y.shape[1] > 1:
            y = y.argmax(axis=1)
        y = y.astype(np.int32) if np.issubdtype(y.dtype, np.integer) \
            else y.astype(np.float32)
        return [Sample(xi, yi) for xi, yi in zip(x, y)]

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, distributed: bool = False) -> "KerasModel":
        if self._criterion is None:
            raise RuntimeError("call compile(optimizer, loss) before fit")
        from bigdl_tpu_torch.dataset import DataSet
        from bigdl_tpu_torch.dataset.sample import SampleToMiniBatch
        from bigdl_tpu_torch.optim import LocalOptimizer, Trigger
        from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
        self._check_input(x if isinstance(x, np.ndarray) else None)
        if distributed and self.device is None:
            from bigdl_tpu_torch.utils.engine import Engine
            self.device = Engine.device()
        if isinstance(x, np.ndarray) or isinstance(x, (list, tuple)):
            dataset = DataSet.array(self._to_samples(x, y),
                                    distributed=distributed) \
                >> SampleToMiniBatch(batch_size)
        else:
            dataset = x  # already a DataSet of MiniBatches
        cls = DistriOptimizer if distributed else LocalOptimizer
        opt = (cls(self._placed(), dataset, self._criterion,
                   device=self.device)
               .set_optim_method(self._optim_method)
               .set_end_when(Trigger.max_epoch(nb_epoch)))
        if validation_data is not None:
            vx, vy = validation_data
            val_ds = DataSet.array(self._to_samples(vx, vy)) \
                >> SampleToMiniBatch(batch_size)
            opt.set_validation(Trigger.every_epoch(), val_ds,
                               self._metrics or [_resolve_metric("accuracy")])
        self._last_optimizer = opt
        opt.optimize()
        return self

    def evaluate(self, x, y=None, batch_size: int = 32):
        from bigdl_tpu_torch.optim.evaluator import Evaluator
        methods = self._metrics or [_resolve_metric("accuracy")]
        samples = self._to_samples(x, y) \
            if isinstance(x, (np.ndarray, list, tuple)) else x
        results = Evaluator(self._placed(), self.device).test(
            samples, methods, batch_size)
        return [r.result()[0] for r, _ in results]

    def _predict_data(self, x):
        # multi-input list → Sample list; Predictor's _as_dataset batches it
        if isinstance(x, (list, tuple)):
            return self._to_samples(x, None)
        return x

    def _predictor(self):
        from bigdl_tpu_torch.optim.evaluator import Predictor
        return Predictor(self._placed(), self.device)

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        self._check_input(x if isinstance(x, np.ndarray) else None)
        return self._predictor().predict(self._predict_data(x), batch_size)

    def predict_classes(self, x, batch_size: int = 32) -> np.ndarray:
        return self._predictor().predict_class(self._predict_data(x),
                                               batch_size)

    def get_weights(self) -> dict:
        """The parameters by path (``named_parameters()``)."""
        return dict(self._module().named_parameters())

    def set_weights(self, params) -> None:
        """Copy a params tree in JAX's layout (``convert.load_jax_params``)
        into the parameters."""
        from bigdl_tpu_torch.convert import load_jax_params
        load_jax_params(self._module(), params)

    def summary(self) -> str:
        lines = [f"{type(self).__name__}:"]
        lines.append(repr(self._module()))
        return "\n".join(lines)


class Sequential(KerasModel):
    """Linear stack with incremental shape inference (first layer needs
    ``input_shape``)."""

    def __init__(self, device=None):
        super().__init__(device)
        self._seq = N.Sequential()
        self._cur_shape: Optional[tuple] = None
        self.layers: list[KerasLayer] = []

    def add(self, layer: KerasLayer) -> "Sequential":
        if self._cur_shape is None:
            if layer.input_shape is None:
                raise ValueError("first layer must declare input_shape")
            self._cur_shape = layer.input_shape
        self._seq.add(layer.build(self._cur_shape))
        self._cur_shape = layer.compute_output_shape(self._cur_shape)
        self.layers.append(layer)
        return self

    @property
    def output_shape(self) -> tuple:
        return self._cur_shape

    def _module(self):
        return self._seq

    def _input_shape(self):
        return self.layers[0].input_shape if self.layers else None


class Model(KerasModel):
    """Functional model over Input()/layer(node) wiring."""

    def __init__(self, input, output, device=None):
        super().__init__(device)
        inputs = input if isinstance(input, (list, tuple)) else [input]
        outputs = output if isinstance(output, (list, tuple)) else [output]
        self._graph = N.Graph([n.node for n in inputs],
                              [n.node for n in outputs])
        self.output_shape = tuple(outputs[0].shape) if len(outputs) == 1 else \
            [tuple(o.shape) for o in outputs]

    def _module(self):
        return self._graph
