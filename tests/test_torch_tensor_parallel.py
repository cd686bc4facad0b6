"""Tensor, expert and sequence parallelism against JAX, 4 gloo ranks.

The JAX side runs in this process on a CPU mesh (``tests/conftest.py``);
the port side runs 4 ranks spawned once for the file
(``tests/torch_ranks.py``), from JAX's weights on JAX's data:

- ``dryrun_multichip(4)``'s dp x tp leg (``megatron_mlp_rules("0", "2")``:
  a column-parallel Linear feeding a row-parallel one) and dp x ep leg
  (the top-2 ``MoE`` with ``expert_parallel_rules``, z-loss and
  ``set_aux_loss_weight(0.01)``), 2 SGD-momentum steps: losses, every
  parameter (split leaves gathered), the MoE's ``dropped_fraction``
  (exactly) and ``aux_loss``; the dp x sp leg (causal ring attention);
- ring attention at sp = 2 (on a 2 x 2 dp x sp mesh) and sp = 4, causal
  and not: output and input gradients against JAX's ``full_attention``;
- a vocab-parallel ``ShardedEmbedding`` (``embedding_parallel_rules``) in
  a dp x tp step; a rule on a leaf no parallel form covers raises;
- MoE routing across ranks (top-1, top-2, expert choice) at capacity
  factor 0.5 with a sharpened gate on shifted inputs, so that the load is
  uneven (1, 7, 4 and 4 of the 16 tokens' first choices) and tokens
  overflow several experts: the port at dp 4 and at dp 2 x ep 2, JAX on
  its 4-device data mesh, 2 steps with ``set_aux_loss_weight(0.01)``:
  loss, parameters, ``dropped_fraction`` and ``expert_load`` (exactly:
  counts over 16 tokens) and ``aux_loss``.
  This holds the lower ranks' count offsets, top-2's second choices
  queued behind every first choice, and expert choice's gathered scores;
- single-device MoE routing (top-1, top-2, expert choice) against JAX's.

Tolerance: fp32, reductions ordered unlike XLA's: 1e-5 relative (2e-5 for
parameters after two momentum steps, 1e-4 for the ring's gradients,
whose streaming softmax sums blocks in ring order), 1e-6 absolute floor.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import dryrun as tdry
from test_torch_distributed import (
    N, RTOL, _flat, _flat_tree, close, in_parallel, jax_device_get, jax_leg,
    jax_train, same_params,
)

LEGS = [("tp", ""), ("ep", ""), ("sp", "")]


def _qkvd():
    rng = np.random.default_rng(9)
    return [rng.normal(size=(2, 2, 8, 4)).astype(np.float32)
            for _ in range(4)]


def _emb_samples():
    rng = np.random.default_rng(10)
    return [(rng.integers(0, 16, size=(3,)).astype(np.int32),
             np.int32(rng.integers(0, 3))) for _ in range(8)]


ROUTERS = ("top1", "top2", "expert_choice")
MOE_MESHES = {"dp4": ((4,), ("data",)),
              "dp2xep2": ((2, 2), ("data", "model"))}


def _moe_samples():
    rng = np.random.default_rng(14)
    return [((rng.normal(size=(8,)) + 0.5).astype(np.float32),
             np.int32(rng.integers(0, 3))) for _ in range(32)]


def jax_moe(router):
    """JAX's MoE model with its gate sharpened (scaled by 10): the
    routing is decisive and the experts' loads uneven."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.parallel import MoE as JMoE
    from bigdl_tpu.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(15)
    m = (jnn.Sequential()
         .add(JMoE(8, 16, n_experts=4, router=router, capacity_factor=0.5,
                   z_loss_weight=1e-3))
         .add(jnn.Linear(8, 3)).add(jnn.LogSoftMax()))
    params = m.get_params()
    gate = np.array(params["0"]["w_gate"])
    gate = gate * 10.0
    params["0"]["w_gate"] = gate
    m.set_params(params)
    return m


def _jax_moe_run(m):
    from bigdl_tpu import nn as jnn
    opt = jax_train(m, _moe_samples(), 16, jnn.ClassNLLCriterion(),
                    MOE_MESHES["dp4"], lr=0.1, aux=0.01)
    st = m.modules[0].get_state()
    return {"loss": float(opt.state["loss"]),
            "params": _flat(jax_device_get(m.get_params())),
            **{leaf: np.asarray(st[leaf]) for leaf in (
                "dropped_fraction", "expert_load", "aux_loss")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.parallel import ShardedEmbedding, embedding_parallel_rules
    from bigdl_tpu.utils.random_generator import RandomGenerator
    tmp = tmp_path_factory.mktemp("tp")
    legs, jruns = {}, []
    for leg, variant in LEGS:
        init, samples, run = jax_leg(leg, variant)
        legs[leg] = (leg, variant, init, samples, 2)
        jruns.append(run)
    RandomGenerator.set_seed(4)
    jm = (jnn.Sequential()
          .add(ShardedEmbedding(jnn.LookupTable(16, 6, zero_based=True)))
          .add(jnn.Select(2, -1)).add(jnn.Linear(6, 3)).add(jnn.LogSoftMax()))
    spec = {"legs": legs, "qkvd": _qkvd(),
            "emb_init": _flat_tree(jm.get_params()),
            "emb_samples": _emb_samples(), "moe": {}}
    moe_runs = []
    for router in ROUTERS:
        m = jax_moe(router)
        for mesh_key, mesh in MOE_MESHES.items():
            spec["moe"][f"{router}/{mesh_key}"] = (
                router, mesh, _flat_tree(m.get_params()), _moe_samples())
        # JAX's numbers do not depend on its mesh (GSPMD computes the global
        # batch): one run on its 4-device data mesh is the reference of
        # both of the port's meshes
        moe_runs.append(lambda m=m: _jax_moe_run(m))

    def embedding():
        opt = jax_train(jm, _emb_samples(), 4, jnn.ClassNLLCriterion(),
                        ((2, 2), ("data", "model")), lr=0.1,
                        tp_rules=embedding_parallel_rules())
        return {"loss": float(opt.state["loss"]),
                "params": _flat(jax_device_get(jm.get_params()))}

    import torch_ranks
    got, res = in_parallel(
        lambda: tdry.spawn(torch_ranks.tensor_parallel_file, N, (spec,),
                           backend="cpu", timeout=300, workdir=str(tmp)),
        jruns + [embedding] + moe_runs)
    want = {leg: r for (leg, _), r in zip(LEGS, res)}
    want["embedding"] = res[len(LEGS)]
    want.update({f"moe/{router}": r for router, r in
                 zip(ROUTERS, res[len(LEGS) + 1:])})
    return got[0], want


def test_dp_x_tp_megatron_mlp_matches_jax(runs):
    got, want = runs
    g, w = got["legs"]["tp"], want["tp"]
    close(g["loss"], w["loss"], RTOL, "loss")
    same_params(g["params"], w["params"])


def test_dp_x_ep_moe_matches_jax(runs):
    got, want = runs
    g, w = got["legs"]["ep"], want["ep"]
    close(g["loss"], w["loss"], RTOL, "loss")
    same_params(g["params"], w["params"])
    assert g["dropped_fraction"] == w["dropped_fraction"]
    close(g["aux_loss"], w["aux_loss"], RTOL, "aux_loss")


def test_dp_x_sp_ring_attention_leg_matches_jax(runs):
    got, want = runs
    close(got["legs"]["sp"]["loss"], want["sp"]["loss"], RTOL, "loss")
    same_params(got["legs"]["sp"]["params"], want["sp"]["params"])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full_attention(runs, sp, causal):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel.ring_attention import full_attention
    q, k, v, dout = (jnp.asarray(a) for a in _qkvd())
    out, vjp = jax.vjp(lambda a, b, c: full_attention(a, b, c,
                                                      causal=causal),
                       q, k, v)
    want = [out, *vjp(dout)]
    got = runs[0][f"ring_sp{sp}_causal={causal}"]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        close(g, np.asarray(w), 1e-4, name)


def test_vocab_parallel_embedding_matches_jax(runs):
    got, want = runs
    close(got["embedding"]["loss"], want["embedding"]["loss"], RTOL, "loss")
    same_params(got["embedding"]["params"], want["embedding"]["params"])


def test_uncovered_rule_raises_naming_the_path(runs):
    msg = runs[0]["uncovered"]
    assert msg is not None and "0/weight" in msg \
        and "no tensor-parallel form" in msg


@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
@pytest.mark.parametrize("router", ROUTERS)
def test_moe_routing_across_ranks_matches_jax(runs, router, mesh):
    got, want = runs
    g, w = got[f"moe/{router}/{mesh}"], want[f"moe/{router}"]
    # tokens dropped, and first choices spread over three experts or more
    assert float(w["dropped_fraction"]) > 0
    assert np.count_nonzero(w["expert_load"]) >= 3
    assert g["dropped_fraction"] == w["dropped_fraction"]
    np.testing.assert_array_equal(g["expert_load"], w["expert_load"])
    close(g["aux_loss"], w["aux_loss"], RTOL, "aux_loss")
    close(g["loss"], w["loss"], RTOL, "loss")
    same_params(g["params"], w["params"])


@pytest.mark.parametrize("router", ["top1", "top2", "expert_choice"])
def test_moe_on_one_device_matches_jax(router):
    import jax
    import jax.numpy as jnp
    from bigdl_tpu.parallel import MoE as JMoE
    from bigdl_tpu.utils.random_generator import RandomGenerator
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.nn.misc import collecting_aux_losses
    from bigdl_tpu_torch.parallel import MoE
    RandomGenerator.set_seed(12)
    jm = JMoE(8, 16, n_experts=4, router=router, capacity_factor=0.75,
              z_loss_weight=1e-3)
    tm = MoE(8, 16, n_experts=4, router=router, capacity_factor=0.75,
             z_loss_weight=1e-3)
    convert.load_jax_params(tm, _flat_tree(jm.get_params()))
    x = np.random.default_rng(13).normal(size=(3, 5, 8)).astype(np.float32)

    def jloss(p):
        y, st = jm.apply(p, jm.get_state(), jnp.asarray(x), training=True)
        return jnp.sum(y * y) + 0.01 * st["aux_loss"] + st["penalty"], st

    (jl, jst), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jm.get_params())
    xt = torch.from_numpy(x)
    from bigdl_tpu_torch.nn.misc import collecting_penalties
    with collecting_aux_losses() as aux, collecting_penalties() as pen:
        y = tm(xt)
    loss = (y * y).sum() + 0.01 * sum(aux, torch.zeros(())) + sum(pen)
    loss.backward()
    close(float(loss.detach()), float(jl), RTOL, "loss")
    for leaf in ("aux_loss", "router_z_loss", "expert_load_max",
                 "dropped_fraction"):
        close(float(getattr(tm, leaf)), float(jst[leaf]), RTOL, leaf)
    jflat = _flat(jax.device_get(jg))
    for n, p in tm.named_parameters():
        close(p.grad.numpy(), jflat[n], 1e-4, n)
