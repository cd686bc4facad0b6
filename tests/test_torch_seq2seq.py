"""The seq2seq Transformer of the port (``models/transformer``,
``nn.CrossAttention``, ``nn/transformer_layers.py``, the decode cache's
roots) against ``bigdl_tpu/`` on the CPU.

A ``Transformer(40, 42, 32, 2, 1, 1, max_len=16)`` and the layer family at
small widths; weights move from JAX by path (``convert.load_jax_params``),
inputs are made with numpy. Tolerances: forwards within 1e-5 (fp32; the
log-probs of a two-block model through another order of sums); one Adam
step's loss within 1e-5 relative and every gradient within 1e-4 relative
(Frobenius) of JAX's ``jax.grad``; beam sequences equal and scores within
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformer import Transformer as JaxTransformer
from bigdl_tpu.models.transformer import beam_translate as jax_beam_translate
from bigdl_tpu.models.transformer import (
    translate_generate as jax_translate_generate,
)
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models.transformer import (
    Transformer, beam_translate, translate_generate,
)
from bigdl_tpu_torch.models.transformer import train as s2s_main
from bigdl_tpu_torch.utils.table import T

SRC_V, TGT_V, E, HEADS, MAX_LEN = 40, 42, 32, 2, 16
BOS, EOS = TGT_V - 2, TGT_V - 1


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models here are small, and the suite's
    workers share the host's cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    JaxRNG.set_seed(17)
    jm = JaxTransformer(SRC_V, TGT_V, E, HEADS, 1, 1, max_len=MAX_LEN)
    tm = Transformer(SRC_V, TGT_V, E, HEADS, 1, 1, max_len=MAX_LEN,
                     device="cpu")
    convert.load_jax_params(tm, _host(jm.get_params()))
    return jm.evaluate(), tm.eval()


def _batch(seed, n=3, ts=9, tt=7):
    r = np.random.default_rng(seed)
    return (r.integers(0, SRC_V, (n, ts)).astype(np.int32),
            r.integers(0, TGT_V, (n, tt)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's log-probs, loss and gradients of one teacher-forced batch,
    from one jitted function (one compile for both tests below)."""
    jm, _ = pair
    src, tin = _batch(2, n=4, ts=8, tt=9)
    tout = np.random.default_rng(3).integers(0, TGT_V, (4, 9)).astype(
        np.int32)
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                        size_average=True)

    def loss(p):
        out, _ = jm.apply(p, jm.get_state(), (jnp.asarray(src),
                                              jnp.asarray(tin)),
                          training=True, rng=None)
        return crit.apply(out, jnp.asarray(tout)), out

    (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jm.get_params())
    return ((src, tin, tout), float(value), np.asarray(out),
            convert.flatten_tree(_host(grads)))


@pytest.mark.parametrize("form", ["table", "tuple"])
def test_forward_log_probs_equal_jax(pair, jax_step, form):
    jm, tm = pair
    (src, tgt, _), _, want, _ = jax_step
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    got = tm(T(s, t) if form == "table" else (s, t)).detach().numpy()
    assert got.shape == (4, 9, TGT_V)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(
        convert.flatten_tree(_host(jm.get_params())))


def test_one_adam_step_loss_and_gradients_equal_jax(pair, jax_step):
    jm, _ = pair
    (src, tin, tout), want_loss, _, want_grads = jax_step
    tm = Transformer(SRC_V, TGT_V, E, HEADS, 1, 1, max_len=MAX_LEN,
                     device="cpu")
    convert.load_jax_params(tm, _host(jm.get_params()))
    opt = toptim.LocalOptimizer(tm, DataSet.array([]), s2s_main.criterion(),
                                device="cpu").set_optim_method(
        toptim.Adam(learningrate=3e-3))
    named, _, _ = opt._prepare_step()
    inp = (torch.from_numpy(src), torch.from_numpy(tin))
    loss, grads = opt._loss_and_grads(list(named.values()), inp,
                                      torch.from_numpy(tout))
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    for n, g in zip(named, grads):
        assert _rel(g.numpy(), want_grads[n]) <= 1e-4, n
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step = opt.train_step(inp, torch.from_numpy(tout))
    assert step == pytest.approx(want_loss, rel=1e-5)
    assert all(not torch.equal(p, before[n])
               for n, p in tm.named_parameters() if n.endswith("weight"))


@pytest.mark.parametrize("search", ["beam_translate", "translate_generate"])
def test_translations_equal_jax(pair, search):
    jm, tm = pair
    src, _ = _batch(4, n=2, ts=6)
    kw = dict(beam_size=3, eos_id=EOS, bos_id=BOS, decode_length=5)
    jax_fn = {"beam_translate": jax_beam_translate,
              "translate_generate": jax_translate_generate}[search]
    port_fn = {"beam_translate": beam_translate,
               "translate_generate": translate_generate}[search]
    want_seqs, want_scores = jax_fn(jm, src, **kw)
    seqs, scores = port_fn(tm, src, device="cpu", **kw)
    assert seqs.shape == (2, 3, 6) and seqs.dtype == torch.int32
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=1e-4)
    assert (seqs[:, :, 0] == BOS).all()
    # the cached search is the full-block search, ties aside
    other = {"beam_translate": translate_generate,
             "translate_generate": beam_translate}[search]
    o_seqs, o_scores = other(tm, src, device="cpu", **kw)
    np.testing.assert_array_equal(o_seqs.numpy(), seqs.numpy())
    np.testing.assert_allclose(o_scores.numpy(), scores.numpy(), atol=1e-5)


def test_cache_roots_leave_the_encoder_uncached(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="causal"):
        tnn.install_decode_cache(tm, 2, 8)       # the encoder is not causal
    with pytest.raises(ValueError, match="roots"):
        tnn.install_decode_cache(tm, 2, 8, roots=[])
    with pytest.raises(ValueError, match="submodule"):
        tnn.install_decode_cache(tm, 2, 8, roots=[tnn.Linear(2, 2)])
    state = tnn.install_decode_cache(tm, 2, 8, roots=[tm[1], tm[2]])
    assert set(state) == {"1", "2"}
    assert state["1"]["1"]["pos_idx"].shape == (2,)
    assert state["2"]["0"]["0"]["1"]["cache_k"].shape == (2, HEADS, 8,
                                                          E // HEADS)
    with pytest.raises(ValueError, match="max_len"):
        tnn.install_decode_cache(tm, 2, MAX_LEN + 1, roots=[tm[1], tm[2]])


# --------------------------------------------------- the layer family
def _layer_case(name, pkg, rng):
    """``(module, input)`` of one layer case, built the same way in either
    package (JAX draws the weights; the port's are loaded)."""
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    if name == "attention_bias":
        bias = np.triu(np.full((5, 5), -1e9, np.float32), 1)[None, None]
        return pkg.Attention(8, 2), (x, x, bias)
    if name == "attention_cross":
        return pkg.Attention(8, 2), (x, rng.normal(size=(2, 3, 8)).astype(
            np.float32))
    if name == "attention_self":
        return pkg.Attention(8, 2), (x,)
    if name == "ffn":
        return pkg.FeedForwardNetwork(8, 16), x
    if name == "layer_normalization":
        return pkg.LayerNormalization(8), x
    if name == "expand_size":
        return pkg.ExpandSize([2, -1, 4]), rng.normal(size=(1, 3, 1)).astype(
            np.float32)
    if name == "table_operation":
        return pkg.TableOperation(pkg.CMulTable()), (
            x, rng.normal(size=(2, 1, 1)).astype(np.float32))
    if name == "cross_attention":
        return pkg.CrossAttention(8, 2), (x, rng.normal(size=(2, 3, 8))
                                          .astype(np.float32))
    raise KeyError(name)


_LAYERS = ["attention_bias", "attention_cross", "attention_self", "ffn",
           "layer_normalization", "expand_size", "table_operation",
           "cross_attention"]


@pytest.mark.parametrize("name", _LAYERS)
def test_layers_equal_jax(name):
    JaxRNG.set_seed(len(name))
    jm, jx = _layer_case(name, jnn, np.random.default_rng(len(name)))
    tm, tx = _layer_case(name, tnn, np.random.default_rng(len(name)))
    convert.load_jax_params(tm, _host(jm.get_params()))
    jm.evaluate()
    tm.eval()
    if isinstance(jx, tuple):
        want = jm.forward(JT(*(jnp.asarray(a) for a in jx)))
        got = tm(T(*(torch.from_numpy(a) for a in tx)))
    else:
        want = jm.forward(jnp.asarray(jx))
        got = tm(torch.from_numpy(tx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_layer_level_transformer_equals_jax(causal):
    JaxRNG.set_seed(23)
    jm = jnn.Transformer(30, 16, 2, 32, 2, causal=causal).evaluate()
    tm = tnn.Transformer(30, 16, 2, 32, 2, causal=causal).eval()
    convert.load_jax_params(tm, _host(jm.get_params()))
    ids = np.random.default_rng(5).integers(0, 30, (2, 7)).astype(np.int32)
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    got = tm(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------- the main
def test_main_trains_and_translates(capsys):
    loss = s2s_main.main(["--device", "cpu", "--max-epoch", "1",
                          "--synthetic-size", "64", "--translate", "2"])
    out = capsys.readouterr().out
    assert np.isfinite(loss) and "final loss:" in out
    assert out.count("held-out src:") == 2
    # --distributed is ported (DistriOptimizer)
    assert not hasattr(s2s_main, "UNPORTED_FLAGS")


@pytest.mark.parametrize("case", ["ok", "ragged", "src_id", "tgt_id"])
def test_main_folder_reader_checks_like_jax(case, tmp_path):
    lines = {"ok": ["1 2 3\t3 2 1", "4 5 6\t6 5 4"],
             "ragged": ["1 2 3\t3 2 1", "4 5\t5 4"],
             "src_id": ["1 2 99\t3 2 1"],
             "tgt_id": ["1 2 3\t3 2 40"]}[case]
    path = tmp_path / "pairs.tsv"
    path.write_text("\n".join(lines) + "\n")
    argv = ["--device", "cpu", "-f", str(path), "-b", "2", "--max-epoch",
            "1", "--translate", "1"]
    if case == "ok":
        assert np.isfinite(s2s_main.main(argv))
        return
    match = {"ragged": "ragged", "src_id": "src id", "tgt_id": "reserved"}
    with pytest.raises(SystemExit, match=match[case]):
        s2s_main.main(argv)
