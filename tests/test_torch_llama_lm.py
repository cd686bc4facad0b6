"""The llama-style TransformerLM of the port (grouped-query heads, RoPE,
RMSNorm + SwiGLU, the fused LM head) end to end against the JAX package,
on the CPU: eval log-probs, one training step's loss and gradients, SGD
trajectories in fp32 and under the bf16 policy, serving, the training
main's new flags, and the port's ``entry()``.

Sizes: V = 50 (the chunk, 24, does not divide it), E = 32, 4 heads over 2
KV heads, 2 layers, T <= 16. Weights move across by path. Tolerances:
eval log-probs within 1e-5; one step's loss within 1e-5 relative and every
gradient within 1e-4 relative (norm of the difference over JAX's norm);
three SGD steps within rtol 1e-4 (losses) and atol 1e-4 (parameters), as
``test_torch_training.py``; the bf16 policy within 2e-2, as
``test_torch_mixed_precision.py``; served tokens equal ``greedy_generate``
and JAX's engine; ``entry()`` within 1e-5 of JAX's.
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
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.models.transformerlm import train as train_main
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.utils import engine as torch_engine

VOCAB, E, HEADS, LAYERS, T, BATCH, CHUNK = 50, 32, 4, 2, 16, 4, 24
LLAMA = dict(num_kv_heads=2, position="rope", norm="rms", mlp_kind="swiglu",
             fused_head=True)


@pytest.fixture(autouse=True)
def engines():
    yield
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _models(seed=3, max_len=T, **opts):
    opts = {**LLAMA, **opts}
    JaxRNG.set_seed(seed)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=max_len, **opts)
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, max_len, device="cpu",
                        **opts)
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _batches(n, seed=1):
    r = np.random.default_rng(seed)
    return [(r.integers(0, VOCAB, size=(BATCH, T)).astype(np.int32),
             r.integers(0, VOCAB, size=(BATCH, T)).astype(np.int32))
            for _ in range(n)]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-30)


def test_eval_log_probs_match_jax():
    jlm, tlm = _models()
    ids = np.random.default_rng(0).integers(0, VOCAB, (2, T)).astype(
        np.int32)
    want = np.asarray(jlm.evaluate().forward(jnp.asarray(ids)))
    with torch.no_grad():
        got = tlm.evaluate()(torch.from_numpy(ids))
    assert got.shape == (2, T, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opts", [{}, dict(remat=True),
                                  dict(num_kv_heads=1, fused_head=False)],
                         ids=["llama", "llama-remat", "mqa-unfused"])
def test_one_training_step_matches_jax_value_and_grad(opts):
    """Loss and every gradient of one step through
    ``lm_criterion(fused_head, chunk_size=24)`` against
    ``jax.value_and_grad`` of the same loss."""
    jlm, tlm = _models(**opts)
    fused = opts.get("fused_head", True)
    x, y = _batches(1)[0]
    jcrit = jax_lm_criterion(fused_head=fused, chunk_size=CHUNK)

    def jloss(params):
        out, _ = jlm.apply(params, jlm.get_state(), jnp.asarray(x),
                           training=True, rng=None)
        return jcrit.apply(out, jnp.asarray(y))

    want, want_g = jax.value_and_grad(jloss)(jlm.get_params())
    want_g = flatten_tree(want_g)
    crit = lm_criterion(fused_head=fused, chunk_size=CHUNK)
    loss = crit(tlm.train()(torch.from_numpy(x)), torch.from_numpy(y))
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    names, params = zip(*tlm.named_parameters())
    for n, g in zip(names, torch.autograd.grad(loss, params)):
        assert _rel(g, want_g[n]) < 1e-4, n


def _jax_trajectory(jlm, method, batches):
    opt = joptim.LocalOptimizer(jlm, JDataSet.array([]),
                                jax_lm_criterion(True, CHUNK))
    opt.set_optim_method(method)
    step = jax.jit(opt._make_step_fn())
    params, mstate = jlm.get_params(), jlm.get_state()
    ostate = method.init_state(params)
    losses = []
    for i, (x, y) in enumerate(batches):
        params, mstate, ostate, loss = step(
            params, mstate, ostate, jnp.asarray(i, jnp.int32),
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, flatten_tree(jax.device_get(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_sgd_steps_match_jax(dtype):
    """``LocalOptimizer`` on the llama model: the criterion receives the
    head's Table, cast back to fp32 under the bf16 policy (both packages),
    and the update follows JAX's."""
    if dtype == "bfloat16":
        jax_engine.Engine.init(seed=3, compute_dtype=jnp.bfloat16)
        torch_engine.Engine.init(compute_dtype=torch.bfloat16)
    jlm, tlm = _models()
    batches = _batches(3)
    method = dict(learningrate=0.5, momentum=0.9, dampening=0.0)
    want_losses, want_params = _jax_trajectory(jlm, joptim.SGD(**method),
                                               batches)
    opt = (toptim.LocalOptimizer(tlm, DataSet.array([]),
                                 lm_criterion(True, CHUNK), device="cpu")
           .set_optim_method(toptim.SGD(**method)))
    losses = [opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
              for x, y in batches]
    rtol, atol = (1e-4, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(losses, want_losses, rtol=rtol)
    for name, p in tlm.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(want_params[name]),
                                   atol=atol, err_msg=name)


def test_dropout_training_draws_fresh_masks_and_evaluates_plainly():
    """With dropout two training-mode forwards draw different masks, and
    eval mode is dropout-free (equal to JAX's eval log-probs)."""
    jlm, tlm = _models(dropout=0.3)
    x, y = _batches(1)[0]
    crit = lm_criterion(True, CHUNK)
    torch.manual_seed(0)
    tlm.train()
    with torch.no_grad():
        a = crit(tlm(torch.from_numpy(x)), torch.from_numpy(y))
        b = crit(tlm(torch.from_numpy(x)), torch.from_numpy(y))
    assert a.item() != b.item()
    want = np.asarray(jlm.evaluate().forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tlm.evaluate()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_serving_engine_on_the_llama_model_matches_greedy_and_jax():
    """Six mixed-length requests on three slots: every request's tokens
    equal the port's solo ``greedy_generate`` and JAX's engine; the caches
    are kv-head wide and there is no position table."""
    jlm, tlm = _models(max_len=64)
    jlm.evaluate()
    r = np.random.default_rng(4)
    reqs = [(r.integers(0, VOCAB, n).astype(np.int32), int(m))
            for n, m in zip([3, 29, 12, 40, 7, 18], r.integers(4, 12, 6))]
    with JaxServingEngine(jlm, 64, slots=3) as jeng:
        want = [h.result(120).tokens for h in
                [jeng.submit(p, m) for p, m in reqs]]
    with ServingEngine(tlm, 64, slots=3, device="cpu") as eng:
        got = [h.result(120) for h in [eng.submit(p, m) for p, m in reqs]]
        cache_k = eng._dec_state["1"]["0"]["0"]["1"]["1"]["cache_k"]
        assert tuple(cache_k.shape) == (3, 2, 64, E // HEADS)
    assert tlm.training                    # the engine gave the mode back
    for (p, m), w, g in zip(reqs, want, got):
        solo = tnn.greedy_generate(tlm, p[None], m, device="cpu")[0]
        np.testing.assert_array_equal(g.tokens, solo.numpy())
        np.testing.assert_array_equal(g.tokens, np.asarray(w))


@pytest.mark.parametrize("flags", [
    ["--rope"], ["--num-kv-heads", "1"], ["--norm", "rms"],
    ["--mlp", "swiglu"], ["--fused-head"], ["--dropout", "0.1"],
    ["--rope", "--num-kv-heads", "2", "--norm", "rms", "--mlp", "swiglu",
     "--fused-head", "--generate", "5", "--beam", "2"],
], ids=["rope", "kv-heads", "rms", "swiglu", "fused-head", "dropout",
        "llama-generate"])
def test_train_main_takes_each_new_flag(flags, capsys):
    loss = train_main.main(["--device", "cpu", "-b", "4", "--seq-len", "16",
                            "--embed-dim", "32", "--num-heads", "4",
                            "--vocab-size", "64", "--max-iteration", "2",
                            "--synthetic-tokens", "2000", *flags])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "final loss:" in out
    if "--generate" in flags:
        ids = eval(out.split("generated ids:")[1].strip())
        assert len(ids) == 16 // 4 + 5 and all(0 <= i < 64 for i in ids)
    assert not hasattr(train_main, "UNPORTED_FLAGS")


def test_entry_matches_jax_entry():
    from bigdl_tpu.dryrun import entry as jax_entry
    from bigdl_tpu_torch.dryrun import entry

    jfwd, (jparams, jtokens) = jax_entry()
    want = np.asarray(jfwd(jparams, jtokens))
    fwd, (params, tokens) = entry(device="cpu")
    assert sorted(params) == sorted(flatten_tree(jparams))
    moved = {n: torch.from_numpy(np.array(a))
             for n, a in flatten_tree(jparams).items()}
    with torch.no_grad():
        got = fwd(moved, tokens)
    assert tuple(tokens.shape) == tuple(jtokens.shape) == (4, 256)
    assert got.shape == (4, 256, 1024)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if not torch.cuda.is_available():        # the card by default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
