"""Every training main's ``--distributed`` at world 2 against JAX's main.

The 13 mains (``bigdl_tpu_torch/models/*/train.py``) run at a small size
(``tests/torch_ranks.py`` ``MAINS``, the same arguments for both packages)
with ``--distributed``: the port on 2 gloo ranks spawned once for the
file (``DistriOptimizer`` over the Engine mesh), JAX in this process on a
2-device CPU mesh (its ``DistriOptimizer`` over the conftest's devices;
``Engine.init`` is held to 2 of them, also where a JAX main calls it
itself). Both start from the same weights: JAX's main builds its model
first (and stops there), and the port's main builds its own, into which
JAX's weights and state are loaded (``convert``); then each package's
main trains, dropout off in both (each package draws its masks from its
own generator). Both packages' mains seed their shuffles alike
(``BIGDL_SEED`` through ``Engine.init``, 0 in the LM main), so no seed is
aligned here.

Every iteration's loss agrees within 1e-5 relative (fp32, reductions
ordered unlike XLA's), the two ranks report the same losses, and, as an
extra, the port's local run (``LocalOptimizer``) from the same weights
gives the same losses as its distributed one.
"""

import importlib

import numpy as np
import pytest

import torch_ranks
from bigdl_tpu_torch import dryrun as tdry
from test_torch_distributed import in_parallel

#: main -> (models package the constructor lives in, constructor)
CTORS = {
    "autoencoder": ("autoencoder", "Autoencoder"),
    "inception": ("inception", "Inception_v1_NoAuxClassifier"),
    "lenet": ("lenet", "LeNet5"),
    "ncf": ("ncf", "NeuralCF"),
    "resnet": ("resnet", "ResNet"),
    "rnn": ("rnn", "PTBModel"),
    "ssd": ("ssd", "SSD"),
    "textclassifier": ("textclassifier", "TextClassifier"),
    "transformer": ("transformer", "Transformer"),
    "transformerlm": ("transformerlm", "TransformerLM"),
    "treelstm": ("treelstm.train", "build_model"),
    "vgg": ("vgg", "VggForCifar10"),
    "widedeep": ("widedeep", "WideAndDeep"),
}

RTOL = 1e-5


class _Built(Exception):
    """Raised by the recording constructor: JAX's main stops there."""


def _walk(m):
    yield m
    for _, child in (m.named_children() if hasattr(m, "named_children")
                     else ()):
        yield from _walk(child)


def _tree(model) -> dict:
    import jax
    get = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))
    return {"params": get(model.get_params()),
            "state": get(model.get_state())}


class _JaxMain:
    """JAX's main ``name`` with ``--distributed`` on 2 CPU devices."""

    def __init__(self, name: str):
        self.name = name
        self.argv = list(torch_ranks.MAINS[name]) + ["--distributed"]
        module, self.ctor = CTORS[name]
        self.pkg = importlib.import_module(f"bigdl_tpu.models.{module}")
        self.main = importlib.import_module(f"bigdl_tpu.models.{name}.train")

    def _run(self, build):
        from bigdl_tpu.utils.engine import Engine
        init = Engine.init.__func__
        ctor = getattr(self.pkg, self.ctor)
        Engine.init = classmethod(
            lambda cls, *a, **k: init(cls, *a, **{"core_number": 2, **k}))
        setattr(self.pkg, self.ctor, build)
        try:
            Engine.reset()
            self.main.main(self.argv)
        finally:
            setattr(self.pkg, self.ctor, ctor)
            Engine.init = classmethod(init)
            Engine.reset()

    def build(self) -> dict:
        """The main's model as it builds it: its weights and state, and
        how many dropout layers it has (switched off for the run)."""
        from bigdl_tpu.nn import Dropout
        ctor = getattr(self.pkg, self.ctor)

        def record(*a, **k):
            self.model = ctor(*a, **k)
            raise _Built

        with pytest.raises(_Built):
            self._run(record)
        drops = [m for m in _walk(self.model) if isinstance(m, Dropout)]
        for d in drops:
            d.set_p(0.0)
        return dict(_tree(self.model), dropouts=len(drops))

    def losses(self) -> list:
        """Train the built model (no draw of the constructor's this time,
        as in the port's main) and return every iteration's loss."""
        from bigdl_tpu.optim.optimizer import Optimizer
        seen = []
        guard = Optimizer._guard_loss

        def record(opt, it, v):
            seen.append(float(v))
            return guard(opt, it, v)

        Optimizer._guard_loss = record
        try:
            self._run(lambda *a, **k: self.model)
        finally:
            Optimizer._guard_loss = guard
        return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mains")
    mains = {name: _JaxMain(name) for name in torch_ranks.MAINS}
    built = {name: m.build() for name, m in mains.items()}
    models = {name: CTORS[name] + (built[name],) for name in mains}
    got, (want, local) = in_parallel(
        lambda: tdry.spawn(torch_ranks.run_mains, 2, (True, None, models),
                           backend="cpu", timeout=300, workdir=str(tmp)),
        [lambda: {name: m.losses() for name, m in mains.items()},
         lambda: torch_ranks.run_mains(False, None, models)])
    return got, want, local, built


@pytest.mark.parametrize("name", sorted(torch_ranks.MAINS))
def test_main_at_world_2_is_the_global_batch_run(runs, name):
    (rank0, rank1), want, local, built = runs
    a, b = rank0[name], rank1[name]
    assert a == b                        # every rank reports one loss
    assert a["dropouts"] == built[name]["dropouts"]
    assert len(a["losses"]) == len(want[name]) > 0
    assert all(np.isfinite(a["losses"]))
    np.testing.assert_allclose(a["losses"], want[name], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(a["losses"], local[name]["losses"],
                               rtol=RTOL, atol=1e-7)
