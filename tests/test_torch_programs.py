"""The port's program cache (``utils/programs.py``) and launch accounting
across replays (``kernels/_cuda.py``), on the CPU.

On the CPU a program runs its function eagerly at every call; these tests
pin what the card's path relies on and the CPU can show: the ledger of
keys, the static inputs, launch records counted once per replay and not
at capture, and that the serving and training programs read no tensor
value on the host (``float(t)``, ``bool(t)``, ``t.item()``, indexing by a
0-d tensor all do), which a captured graph could not replay.
"""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.kernels import _cuda
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.optim import LBFGS, SGD, Adam, LocalOptimizer
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.utils import programs
from bigdl_tpu_torch.utils.engine import Engine


def test_program_cache_ledger_on_the_cpu():
    cache = programs.ProgramCache("cpu")
    builds = []

    def build(scale):
        def b():
            builds.append(scale)
            buf = torch.zeros(3)
            return (lambda x: x * scale), (buf,)
        return b

    p2 = cache.get_or_capture(("times", 2), build(2))
    p3 = cache.get_or_capture(("times", 3), build(3))
    assert cache.get_or_capture(("times", 2), build(2)) is p2
    assert builds == [2, 3] and cache.keys == [("times", 2), ("times", 3)]
    p2.inputs[0].copy_(torch.tensor([1.0, 2.0, 3.0]))
    assert p2().tolist() == [2.0, 4.0, 6.0]
    p2.inputs[0].fill_(1.0)                 # the next call reads it anew
    assert p2().tolist() == [2.0, 2.0, 2.0]
    assert not p2.captured and p2.replays == 0 and p3.key == ("times", 3)


def test_launches_recorded_at_capture_count_at_each_replay():
    counter = _cuda.LaunchCounter("test_kernel")
    stream = 0x5EED
    counter.add("float32")
    with _cuda.recording_launches(stream) as rec:
        counter.add("float32", stream)      # recorded, ran nothing
        counter.add("bfloat16", stream, n=2)
        counter.add("float32", stream + 1)  # another stream: counted
    assert counter.count == 2
    assert rec == {(counter, "float32"): 1, (counter, "bfloat16"): 2}
    for _ in range(3):
        _cuda.replay_launches(rec)
    assert counter.count == 2 + 9
    assert counter.by_dtype == {"float32": 5, "bfloat16": 6}
    counter.add("float32", stream)          # the record is closed
    assert counter.count == 12


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a program read a tensor on the host")
        return func(*args, **(kwargs or {}))


def _guarded(monkeypatch):
    """Run every program call under :class:`_NoHostReads`; returns the
    keys called."""
    called = []
    call = programs.Program.__call__

    def guarded(self):
        called.append(self.key)
        with _NoHostReads():
            return call(self)

    monkeypatch.setattr(programs.Program, "__call__", guarded)
    return called


def test_serving_programs_make_no_host_read(monkeypatch):
    called = _guarded(monkeypatch)
    lm = TransformerLM(64, 32, 4, 2, 64, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with ServingEngine(lm, 64, slots=2, device="cpu") as eng:
        for h in [eng.submit(np.arange(n) % 64, 4) for n in (5, 20, 40)]:
            assert h.result(60).n_generated == 4
        keys = eng._programs.keys
    assert {k[0] for k in called} == {"serve_prefill", "serve_assign",
                                      "serve_decode"}
    assert set(called) == set(keys) and len(keys) == 5


def test_training_step_programs_make_no_host_read(monkeypatch):
    """Every option of the step that rides inside its program: remat,
    clipping, accumulation, bf16, a frozen block, and methods with and
    without step-dependent numbers (LBFGS keeps its bookkeeping on the
    device)."""
    called = _guarded(monkeypatch)
    x = torch.randint(0, 64, (4, 16), generator=torch.Generator()
                      .manual_seed(1))
    configs = [
        lambda o: o.set_optim_method(Adam(learningrate=1e-2))
        .set_remat("dots").set_gradient_clipping_by_l2_norm(1.0),
        lambda o: o.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
        .set_gradient_accumulation(2).set_constant_gradient_clipping(-1, 1)
        .set_flat_update(True),
        lambda o: o.set_optim_method(LBFGS(history=3)),
    ]
    try:
        for i, configure in enumerate(configs):
            Engine.init(compute_dtype=torch.bfloat16 if i == 1
                        else torch.float32)
            lm = TransformerLM(64, 32, 4, 2, 16, device="cpu",
                               remat=i == 0)
            if i == 2:
                lm[2].freeze()
            opt = configure(LocalOptimizer(lm, DataSet.array([]),
                                           lm_criterion(), device="cpu"))
            losses = [opt.train_step(x, x) for _ in range(2)]
            assert np.isfinite(losses).all()
    finally:
        Engine.reset()
    assert len(called) == 6 and all(k[0] == "train_step" for k in called)
