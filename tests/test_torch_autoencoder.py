"""The port's MNIST autoencoder against the JAX package, on the CPU.

- ``Autoencoder(32)``: the forward on flat and (1, 28, 28) images and the
  gradients of ``sum(out * w)`` (outputs 1e-5, gradients 1e-4 relative);
- three steps of the main's training (``Adam(0.01)``, ``MSECriterion``,
  the images scaled to [0, 1] as input and target, batch 128 of the
  synthetic MNIST split) through the port's ``LocalOptimizer`` and JAX's
  step function from the same weights and batches: losses within 1e-5,
  parameters within 1e-4 relative;
- the main on ``--device cpu`` (its per-iteration losses fall, the final
  loss printed), JAX's flags and defaults, ``--folder`` and
  ``--distributed`` refused naming their ROADMAP items, and the card
  needed by default.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.mnist import load_mnist as jload_mnist
from bigdl_tpu.models.autoencoder import Autoencoder as JAutoencoder
from bigdl_tpu.models.autoencoder import train as jtrain
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.mnist import load_mnist
from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.autoencoder import train as main
from bigdl_tpu_torch.utils import engine as torch_engine


@pytest.fixture(autouse=True)
def _one_thread_and_reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _pair():
    JaxRNG.set_seed(4)
    jm = JAutoencoder(32)
    tm = Autoencoder(32, device="cpu")
    tree = jax.device_get(jm.get_params())
    assert sorted(flatten_tree(tree)) == sorted(
        n for n, _ in tm.named_parameters()) == [
        "1.bias", "1.weight", "3.bias", "3.weight"]
    load_jax_params(tm, tree)
    return jm, tm


def _images(n, seed=0):
    imgs, _ = load_mnist(None, "train", synthetic_size=n)
    want, _ = jload_mnist(None, "train", synthetic_size=n)
    np.testing.assert_array_equal(imgs, want)
    return (imgs.astype(np.float32) / 255.0).reshape(n, -1)


@pytest.mark.parametrize("shape", [(4, 784), (4, 1, 28, 28)],
                         ids=["flat", "images"])
def test_autoencoder_forward_and_gradients_match_jax(shape):
    jm, tm = _pair()
    x = _images(4).reshape(shape)
    want = jm.apply(jm.get_params(), jm.get_state(), jnp.asarray(x))[0]
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: (jm.apply(p, jm.get_state(), xx)[0]
                                     * w).sum(),
                      argnums=(0, 1))(jm.get_params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    assert got.shape == (4, 784)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(xt.grad.numpy(), gx) <= 1e-4
    gp = flatten_tree(jax.device_get(gp))
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), gp[n]) <= 1e-4, n


def test_three_training_steps_match_jax():
    jm, tm = _pair()
    flat = _images(3 * 128)
    batches = [flat[i * 128:(i + 1) * 128] for i in range(3)]
    jopt = joptim.LocalOptimizer(jm, JDataSet.array([]), jnn.MSECriterion())
    jopt.set_optim_method(joptim.Adam(learningrate=0.01))
    step = jax.jit(jopt._make_step_fn())
    params, mstate = jm.get_params(), jm.get_state()
    ostate = jopt.optim_method.init_state(params)
    jlosses = []
    for i, b in enumerate(batches):
        params, mstate, ostate, loss = step(
            params, mstate, ostate, jnp.asarray(i, jnp.int32),
            jnp.asarray(b), jnp.asarray(b), jax.random.PRNGKey(0))
        jlosses.append(float(loss))
    topt = (toptim.LocalOptimizer(tm, DataSet.array([]), nn.MSECriterion(),
                                  device="cpu")
            .set_optim_method(toptim.Adam(learningrate=0.01)))
    losses = [topt.train_step(torch.from_numpy(b), torch.from_numpy(b))
              for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    flat_p = flatten_tree(jax.device_get(params))
    for n, p in tm.named_parameters():
        assert _rel(p.detach().numpy(), flat_p[n]) <= 1e-4, n


def test_main_trains_on_the_cpu(caplog, capsys):
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch.optim.optimizer")
    opt = main.main(["--device", "cpu", "-b", "64", "--synthetic-size",
                     "512", "--max-epoch", "2"])
    losses = [r.args[2] for r in caplog.records
              if r.getMessage().startswith("Epoch")]
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert opt.state["loss"] == pytest.approx(losses[-1])
    assert "final loss:" in capsys.readouterr().out


def test_main_has_jax_flags_and_refuses_the_unported():
    parser = main.build_parser()
    jparser = jtrain.build_parser()
    ours = {a.dest: a.default for a in parser._actions}
    for a in jparser._actions:
        if a.dest in ("help", "distributed"):
            continue
        assert ours[a.dest] == a.default, a.dest
    # --distributed is ported (DistriOptimizer): nothing is refused
    assert not hasattr(main, "UNPORTED_FLAGS")
    assert main.build_parser().parse_args(["--distributed"]).distributed


def test_main_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.main(["--max-epoch", "1"])
