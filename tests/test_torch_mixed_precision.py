"""bf16 mixed-precision training of the port against the JAX package, on
the CPU.

Both packages run the same policy: fp32 master parameters, every floating
parameter (LayerNorm's gamma and beta included) and input cast to bf16
inside the step, the model's output cast to fp32 before the criterion, the
casts' backward giving fp32 gradients, no loss scaling. JAX runs under
``Engine.init(compute_dtype=jnp.bfloat16)`` through its step function
(``Optimizer._make_step_fn``), the port under
``Engine.init(compute_dtype=torch.bfloat16)`` through
``LocalOptimizer.train_step``, on the same numpy batches and weights (moved
across by path). On the CPU, JAX's LayerNorm and attention compute in bf16
while the port's plain versions keep fp32 statistics, so losses are held
to rtol 2e-2 (bf16-sized, a few ulps of 2^-8) and the fp32 masters after
three SGD steps to atol 2e-2. Both engines are reset after each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformerlm import lm_criterion as jax_lm_criterion
from bigdl_tpu.nn.precision import cast_floating as jax_cast_floating
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.kernels import layernorm as ln_module
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.nn import cast_floating
from bigdl_tpu_torch.utils import engine as torch_engine

VOCAB, E, HEADS, LAYERS, T, BATCH = 64, 32, 2, 2, 16, 4
LOSS_RTOL, PARAM_ATOL = 2e-2, 2e-2


@pytest.fixture(autouse=True)
def engines():
    yield
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _bf16_engines():
    jax_engine.Engine.init(seed=3, compute_dtype=jnp.bfloat16)
    torch_engine.Engine.init(compute_dtype=torch.bfloat16)


def _models(seed=3):
    JaxRNG.set_seed(seed)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=T)
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _batches(n, seed=1, batch=BATCH):
    r = np.random.default_rng(seed)
    return [(r.integers(0, VOCAB, size=(batch, T)).astype(np.int32),
             r.integers(0, VOCAB, size=(batch, T)).astype(np.int32))
            for _ in range(n)]


def test_cast_floating_matches_jax():
    r = np.random.default_rng(0)
    tree = {"w": r.normal(size=(3, 4)).astype(np.float32),
            "ids": r.integers(0, 9, size=(5,)).astype(np.int32),
            "mask": np.array([True, False]),
            "nested": [r.normal(size=(2,)).astype(np.float32)]}
    want = jax_cast_floating(tree, jnp.bfloat16)
    got = cast_floating({"w": torch.from_numpy(tree["w"]),
                         "ids": torch.from_numpy(tree["ids"]),
                         "mask": torch.from_numpy(tree["mask"]),
                         "nested": [torch.from_numpy(tree["nested"][0])]},
                        torch.bfloat16)
    assert got["w"].dtype == got["nested"][0].dtype == torch.bfloat16
    assert want["w"].dtype == jnp.bfloat16
    assert got["ids"].dtype == torch.int32 and got["mask"].dtype == torch.bool
    for a, b in ((got["w"], want["w"]), (got["nested"][0], want["nested"][0])):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))


@pytest.mark.parametrize("name", ["float32", "fp32", "bfloat16", "bf16",
                                  "float16", "fp16"])
def test_compute_dtype_names_and_variable_match_jax(name, monkeypatch):
    monkeypatch.setenv("BIGDL_COMPUTE_DTYPE", name)
    jax_engine.Engine.init()
    torch_engine.Engine.reset()
    got, want = torch_engine.Engine.compute_dtype(), \
        jax_engine.Engine.compute_dtype()
    assert str(got).split(".")[-1] == jnp.dtype(want).name


def test_engine_defaults_to_fp32_and_refuses_unknown_names(monkeypatch):
    monkeypatch.delenv("BIGDL_COMPUTE_DTYPE", raising=False)
    assert torch_engine.Engine.compute_dtype() == torch.float32
    torch_engine.Engine.set_compute_dtype(torch.bfloat16)
    assert torch_engine.Engine.compute_dtype() == torch.bfloat16
    torch_engine.Engine.reset()
    assert not torch_engine.Engine.is_initialized()
    monkeypatch.setenv("BIGDL_COMPUTE_DTYPE", "int8")
    with pytest.raises(ValueError, match="BIGDL_COMPUTE_DTYPE"):
        torch_engine.Engine.init()
    with pytest.raises(ValueError, match="BIGDL_COMPUTE_DTYPE"):
        jax_engine._parse_dtype("int8")


def _jax_trajectory(jlm, method, batches, accum=1):
    opt = joptim.LocalOptimizer(jlm, JDataSet.array([]), jax_lm_criterion())
    opt.set_optim_method(method).set_gradient_accumulation(accum)
    step = jax.jit(opt._make_step_fn())
    params, mstate = jlm.get_params(), jlm.get_state()
    ostate = method.init_state(params)
    losses = []
    for i, (x, y) in enumerate(batches):
        params, mstate, ostate, loss = step(
            params, mstate, ostate, jnp.asarray(i, jnp.int32),
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("accum", [1, 2])
def test_three_sgd_steps_in_bf16_match_jax(accum):
    """Three SGD steps of a 2-layer, width-32 TransformerLM under bf16
    compute in both packages (gradient accumulation composing unchanged):
    losses within rtol 2e-2, the fp32 masters within atol 2e-2, and the
    port's bf16 run differs from its fp32 run (the policy is live)."""
    _bf16_engines()
    jlm, tlm = _models()
    batches = _batches(3)
    method = dict(learningrate=0.5, momentum=0.9, dampening=0.0)
    want_losses, want_params = _jax_trajectory(
        jlm, joptim.SGD(**method), batches, accum)
    opt = (toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                                 device="cpu")
           .set_optim_method(toptim.SGD(**method))
           .set_gradient_accumulation(accum))
    losses = [opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
              for x, y in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    flat = flatten_tree(jax.device_get(want_params))
    for name, p in tlm.named_parameters():
        assert p.dtype == torch.float32 and flat[name].dtype == np.float32
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat[name]),
                                   atol=PARAM_ATOL, err_msg=name)
    torch_engine.Engine.set_compute_dtype(torch.float32)
    _, fp32_lm = _models()
    fp32 = (toptim.LocalOptimizer(fp32_lm, DataSet.array([]), lm_criterion(),
                                  device="cpu")
            .set_optim_method(toptim.SGD(**method))
            .set_gradient_accumulation(accum))
    fp32_loss = fp32.train_step(*map(torch.from_numpy, batches[0]))
    assert fp32_loss != losses[0]
    assert fp32_loss == pytest.approx(losses[0], rel=LOSS_RTOL)


def test_bf16_step_gives_layer_norm_bf16_gamma_and_fp32_gradients(
        monkeypatch):
    """Every LayerNorm of the bf16 step sees bf16 x, gamma and beta, its
    backward returns dgamma in bf16, and the gradients reaching the update
    are fp32."""
    torch_engine.Engine.init(compute_dtype=torch.bfloat16)
    _, tlm = _models()
    seen = []
    plain_fwd, plain_bwd = ln_module.layer_norm_reference, \
        ln_module.layer_norm_backward

    def fwd(x, gamma, beta, eps=1e-5):
        seen.append(("fwd", x.dtype, gamma.dtype, beta.dtype))
        return plain_fwd(x, gamma, beta, eps)

    def bwd(x, gamma, eps, g):
        out = plain_bwd(x, gamma, eps, g)
        seen.append(("bwd", x.dtype, out[1].dtype, out[2].dtype))
        return out

    monkeypatch.setattr(ln_module, "layer_norm_reference", fwd)
    monkeypatch.setattr(ln_module, "layer_norm_backward", bwd)
    grads_seen = []
    method = toptim.SGD(learningrate=0.1)
    update = method.update_with      # the trainer's update, h on device

    def spy(params, grads, state, h):
        grads_seen.extend(g.dtype for g in grads.values())
        return update(params, grads, state, h)

    method.update_with = spy
    before = kernels.launch_counts()
    (x, y), = _batches(1)
    (toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                           device="cpu").set_optim_method(method)
     .train_step(torch.from_numpy(x), torch.from_numpy(y)))
    n_ln = 2 * LAYERS + 1
    assert seen.count(("fwd",) + (torch.bfloat16,) * 3) == n_ln
    assert seen.count(("bwd",) + (torch.bfloat16,) * 3) == n_ln
    assert len(seen) == 2 * n_ln
    assert set(grads_seen) == {torch.float32}
    assert all(p.dtype == torch.float32 for p in tlm.parameters())
    assert kernels.launch_counts() == before     # CPU: plain versions only


def test_train_main_trains_in_bf16_with_remat(monkeypatch, capsys):
    """``BIGDL_COMPUTE_DTYPE=bf16`` and ``--remat`` through the training
    main: the loss matches the same run without remat bit for bit and the
    fp32 run within rtol 2e-2."""
    from bigdl_tpu_torch.models.transformerlm import train as train_main

    args = ["--device", "cpu", "-b", "4", "--seq-len", "16", "--embed-dim",
            "32", "--num-heads", "2", "--vocab-size", "64",
            "--max-iteration", "3", "--synthetic-tokens", "2000"]
    monkeypatch.setenv("BIGDL_COMPUTE_DTYPE", "bf16")
    torch_engine.Engine.reset()
    bf16_remat = train_main.main(args + ["--remat"])
    assert torch_engine.Engine.compute_dtype() == torch.bfloat16
    torch_engine.Engine.reset()
    bf16 = train_main.main(args)
    monkeypatch.setenv("BIGDL_COMPUTE_DTYPE", "fp32")
    torch_engine.Engine.reset()
    fp32 = train_main.main(args)
    assert bf16_remat == bf16 != fp32
    assert bf16 == pytest.approx(fp32, rel=LOSS_RTOL)
    assert capsys.readouterr().out.count("final loss:") == 3
