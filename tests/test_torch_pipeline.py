"""Pipeline parallelism (``GPipe``) against JAX, 4 gloo ranks on the CPU.

The JAX side runs in this process on a CPU mesh (``tests/conftest.py``);
the port side runs 4 ranks spawned once for the file
(``tests/torch_ranks.py``), from JAX's weights on JAX's data:

- ``dryrun_multichip(4)``'s dp x pp legs (the heterogeneous LM: embedding,
  two transformer blocks, head; a 1 x 4 mesh) under ``gpipe`` and
  ``1f1b``, 2 SGD-momentum steps: loss and every parameter against JAX's
  1f1b leg (JAX pins its schedules bit-identical), and bitwise against
  each other;
- one pipelined step's gradients at 1 x 4 and 2 x 2 (dp x pp): 1F1B's
  equal GPipe's bitwise (both accumulate a stage's microbatches in order
  from the same stage graphs), and both equal JAX's autodiff of the whole
  model within 1e-5 relative;
- the pipelined forward against JAX's; the schedule table is JAX's; the
  stage checks refuse state and dropout.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import dryrun as tdry
from test_torch_distributed import (
    N, RTOL, _flat, _flat_tree, close, in_parallel, jax_leg, jax_model,
    same_params,
)

LEGS = [("pp", "gpipe"), ("pp", "1f1b")]
# JAX pins its two schedules' gradients bit-identical, so its 1f1b leg is
# the reference of both of the port's (the gpipe leg's compile alone
# would double the file's time)
JAX_LEGS = [("pp", "1f1b")]


def _xy():
    rng = np.random.default_rng(14)
    return (rng.integers(0, 32, size=(8, 8)).astype(np.int64),
            rng.integers(0, 32, size=(8, 8)).astype(np.int64))


def _jax_grads(model, x, y):
    """JAX's loss and gradients of the whole model off the mesh (the
    stages in a row on the whole batch)."""
    import jax
    import jax.numpy as jnp
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.utils.engine import Engine
    Engine.reset()
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                        size_average=True)

    def loss(p):
        out, _ = model.apply(p, model.get_state(), jnp.asarray(x),
                             training=True)
        return crit.apply(out, jnp.asarray(y))

    val, g = jax.jit(jax.value_and_grad(loss))(model.get_params())
    out, _ = jax.jit(lambda p: model.apply(p, model.get_state(),
                                           jnp.asarray(x), training=False)
                     )(model.get_params())
    return float(val), _flat(jax.device_get(g)), np.asarray(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    legs, jruns = {}, []
    for leg, variant in LEGS:
        init, samples, run = jax_leg(leg, variant)
        legs[variant] = (leg, variant, init, samples, 2)
        if (leg, variant) in JAX_LEGS:
            jruns.append(run)
    x, y = _xy()
    m4, m2 = jax_model("pp", 4), jax_model("pp", 2)
    spec = {"legs": legs, "xy": (x, y), "init4": _flat_tree(m4.get_params()),
            "init2": _flat_tree(m2.get_params())}
    import torch_ranks
    got, res = in_parallel(
        lambda: tdry.spawn(torch_ranks.pipeline_file, N, (spec,),
                           backend="cpu", timeout=300, workdir=str(tmp)),
        jruns + [lambda: _jax_grads(m4, x, y), lambda: _jax_grads(m2, x, y)])
    want = {variant: res[0] for _, variant in LEGS}
    want.update(pp4=res[-2], pp2=res[-1])
    return got[0], want


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_dp_x_pp_hetero_lm_legs_match_jax(runs, schedule):
    got, want = runs
    g, w = got["legs"][schedule], want[schedule]
    close(g["loss"], w["loss"], RTOL, "loss")
    same_params(g["params"], w["params"])
    # and the port's two schedules train bit for bit alike
    other = got["legs"]["1f1b" if schedule == "gpipe" else "gpipe"]
    assert g["loss"] == other["loss"]
    for n in g["params"]:
        assert np.array_equal(g["params"][n], other["params"][n]), n


@pytest.mark.parametrize("pp", [4, 2])
def test_1f1b_gradients_equal_gpipe_bitwise_and_jax(runs, pp):
    got, want = runs
    a, b = got[f"gpipe_pp{pp}"], got[f"1f1b_pp{pp}"]
    assert a["loss"] == b["loss"]
    assert set(a["grads"]) == set(b["grads"])
    for n in a["grads"]:
        assert np.array_equal(a["grads"][n], b["grads"][n]), n
    jloss, jgrads, _ = want[f"pp{pp}"]
    close(a["loss"], jloss, RTOL, "loss")
    assert set(a["grads"]) == set(jgrads)
    for n, g in a["grads"].items():
        close(g, jgrads[n], 1e-4, n)


def test_pipelined_forward_matches_jax(runs):
    got, want = runs
    close(got["forward_pp4"], want["pp4"][2], RTOL, "forward")


@pytest.mark.parametrize("s,m", [(2, 2), (4, 2), (4, 6), (3, 5)])
def test_1f1b_schedule_table_is_jax(s, m):
    from bigdl_tpu.parallel.pipeline import _simulate_1f1b as jsim
    from bigdl_tpu_torch.parallel.pipeline import _simulate_1f1b
    for a, b in zip(_simulate_1f1b(s, m), jsim(s, m)):
        assert np.array_equal(a, b)


def test_stage_checks_refuse_state_and_dropout():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import GPipe
    with pytest.raises(ValueError, match="stateless"):
        GPipe(stages=[nn.BatchNormalization(4), nn.Linear(4, 4)])
    with pytest.raises(ValueError, match="RNG"):
        GPipe(stages=[nn.Dropout(0.5), nn.Linear(4, 4)])
    with pytest.raises(ValueError, match="exactly one"):
        GPipe()
    homo = GPipe(nn.Linear(4, 4), n_stages=3)
    x = torch.ones(2, 4)
    with torch.no_grad():
        want = homo[2](homo[1](homo[0](x)))
        assert torch.equal(homo(x), want)       # off the mesh: in a row
