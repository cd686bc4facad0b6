"""The port's text family against the JAX package, on the CPU.

Same weights (moved across by path with ``convert.load_jax_params``), same
numpy inputs made from a seed, small sizes:

- ``PTBModel`` (vocab 40, hidden 16, 2 layers, bptt 8): the loss and every
  gradient of one step (fp32: loss 1e-5 relative, gradients 1e-4
  relative), then two steps of the main's ``SGD(1.0)``, clipped by the L2
  norm, through the port's ``LocalOptimizer`` against JAX's step function
  (losses 1e-5, parameters 1e-5); under the bf16 policy one step of both
  trainers (the output fp32 behind the LSTMs in both: loss 1e-2,
  parameters after the step within 2e-2 relative of JAX's);
- ``TemporalConvolution`` and ``TemporalMaxPooling`` (strides, global
  pooling, unbatched input), ``TextClassifier``, ``Select``,
  ``SelectTable``, ``JoinTable`` and ``Squeeze``: outputs within 1e-5,
  gradients within 1e-4 relative;
- the TreeLSTM ``Graph`` of the sentiment main on JAX's synthetic trees
  (1e-5 / 1e-4) and ``TreeNNAccuracy``'s host and device folds against
  JAX's (equal counts);
- ``Dictionary``, ``SentenceTokenizer``, the sentence transformers and
  ``load_ptb`` on a ``ptb.train.txt`` the test writes (the same ids and
  words as JAX's), and the synthetic fallback;
- the mains: PTB on that corpus for one epoch with ``--generate``, the
  TreeLSTM and text-classifier mains for one tiny epoch, the transformer
  LM main on a corpus file (``--folder``); ``--distributed`` refused; the
  entry points on the card by default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.models.rnn import PTBModel as JPTBModel
from bigdl_tpu.models.textclassifier import TextClassifier as JTextClassifier
from bigdl_tpu.models.treelstm import train as jtree_main
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import (
    DataSet, Dictionary, LabeledSentenceToSample, SentenceTokenizer,
    TextToLabeledSentence, load_ptb,
)
from bigdl_tpu_torch.models.rnn import PTBModel, SimpleRNN
from bigdl_tpu_torch.models.rnn import train as rnn_main
from bigdl_tpu_torch.models.textclassifier import TextClassifier
from bigdl_tpu_torch.models.textclassifier import train as tc_main
from bigdl_tpu_torch.models.transformerlm import train as lm_main
from bigdl_tpu_torch.models.treelstm import train as tree_main
from bigdl_tpu_torch.optim.evaluator import run_device_eval
from bigdl_tpu_torch.optim.validation import TreeNNAccuracy
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.table import T


@pytest.fixture(autouse=True)
def _reset():
    yield
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _carry(jm, tm):
    tree = jax.device_get(jm.get_params())
    assert sorted(flatten_tree(tree)) == sorted(
        n for n, _ in tm.named_parameters())
    load_jax_params(tm, tree)
    return tm


def _check(jm, tm, jx, tx, *, grad_x=True):
    """Output within 1e-5 and the gradients of ``sum(out * w)`` (every
    parameter, and the input with ``grad_x``) within 1e-4 relative."""
    want = jm.apply(jm.get_params(), jm.get_state(), jx)[0]
    w = _x(*want.shape, seed=11)

    def jloss(p, xx):
        return (jm.apply(p, jm.get_state(), xx)[0] * w).sum()

    gp, gx = jax.grad(jloss, argnums=(0, 1), allow_int=True)(
        jm.get_params(), jx)
    got = tm(tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    if grad_x:
        assert _rel(tx.grad.numpy(), gx) <= 1e-4
    gp = flatten_tree(jax.device_get(gp))
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), gp[n]) <= 1e-4, n


# ------------------------------------------------------------ the PTB LM
VOCAB, HIDDEN, BPTT, BATCH = 40, 16, 8, 4


def _ptb_pair():
    JaxRNG.set_seed(5)
    jm = JPTBModel(VOCAB, HIDDEN, num_layers=2)
    tm = _carry(jm, PTBModel(VOCAB, HIDDEN, num_layers=2, device="cpu"))
    assert [n for n, _ in tm.named_parameters()][:2] == ["0.weight",
                                                          "1.0.w_ih"]
    return jm, tm


def _ptb_batches(n):
    r = np.random.default_rng(8)
    return [(r.integers(0, VOCAB, (BATCH, BPTT)).astype(np.int32),
             r.integers(0, VOCAB, (BATCH, BPTT)).astype(np.int32))
            for _ in range(n)]


def _jax_steps(jm, batches, clip=5.0):
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                        size_average=True)
    opt = joptim.LocalOptimizer(jm, JDataSet.array([]), crit)
    opt.set_optim_method(joptim.SGD(learningrate=1.0))
    opt.set_gradient_clipping_by_l2_norm(clip)
    step = jax.jit(opt._make_step_fn())
    params, mstate = jm.get_params(), jm.get_state()
    ostate = opt.optim_method.init_state(params)
    losses = []
    for i, (x, y) in enumerate(batches):
        params, mstate, ostate, loss = step(
            params, mstate, ostate, jnp.asarray(i, jnp.int32),
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, flatten_tree(jax.device_get(params))


def _port_steps(tm, batches, clip=5.0):
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    opt = (toptim.LocalOptimizer(tm, DataSet.array([]), crit, device="cpu")
           .set_optim_method(toptim.SGD(learningrate=1.0))
           .set_gradient_clipping_by_l2_norm(clip))
    return [opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
            for x, y in batches]


def test_ptb_model_step_matches_jax():
    jm, tm = _ptb_pair()
    (x, y), = _ptb_batches(1)
    crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                        size_average=True)

    def jloss(p):
        return crit.apply(jm.apply(p, jm.get_state(), jnp.asarray(x))[0],
                          jnp.asarray(y))

    want, gp = jax.value_and_grad(jloss)(jm.get_params())
    tcrit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                        size_average=True)
    loss = tcrit.apply(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    gp = flatten_tree(jax.device_get(gp))
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), gp[n]) <= 1e-4, n
    # two steps of the main's SGD(1.0), clipped by the L2 norm at 0.1 so
    # that the clipping acts (the gradients' norms are about 0.2 here)
    jm, tm = _ptb_pair()
    batches = _ptb_batches(2)
    want_losses, want_params = _jax_steps(jm, batches, clip=0.1)
    losses = _port_steps(tm, batches, clip=0.1)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[n],
                                   atol=1e-5, err_msg=n)


def test_ptb_model_bf16_step_matches_jax():
    jax_engine.Engine.init(compute_dtype=jnp.bfloat16)
    torch_engine.Engine.init(compute_dtype=torch.bfloat16)
    jm, tm = _ptb_pair()
    batches = _ptb_batches(1)
    params0 = {n: p.detach().clone() for n, p in tm.named_parameters()}
    want_losses, want_params = _jax_steps(jm, batches)
    # the LSTMs carry fp32 state: the decoder's input is fp32, its product
    # fp32 (JAX's promotion), the model's output fp32
    from torch.func import functional_call
    out = functional_call(tm, {n: p.to(torch.bfloat16)
                               for n, p in params0.items()},
                          (torch.from_numpy(batches[0][0]),))
    assert out.dtype == torch.float32
    losses = _port_steps(tm, batches)
    assert abs(losses[0] - want_losses[0]) <= 1e-2 * abs(want_losses[0])
    for n, p in tm.named_parameters():
        step = p.detach().numpy() - params0[n].numpy()
        want = want_params[n] - params0[n].numpy()
        assert _rel(step, want) <= 2e-2, n


def test_simple_rnn_matches_jax():
    from bigdl_tpu.models.rnn import SimpleRNN as JSimpleRNN
    JaxRNG.set_seed(6)
    jm = JSimpleRNN(30, 8, 30)
    tm = _carry(jm, SimpleRNN(30, 8, 30, device="cpu"))
    x = np.random.default_rng(1).integers(1, 31, (3, 5)).astype(np.int32)
    _check(jm, tm, jnp.asarray(x), torch.from_numpy(x), grad_x=False)


# ------------------------------------------------- the temporal layers
@pytest.mark.parametrize("kw,dw,pool,pool_stride", [
    (3, 1, 2, None), (2, 2, -1, None), (4, 1, 3, 1)],
    ids=["k3-pool2", "k2-stride2-global", "k4-pool3-stride1"])
def test_temporal_layers_match_jax(kw, dw, pool, pool_stride):
    def build(pkg):
        return (pkg.Sequential()
                .add(pkg.TemporalConvolution(6, 5, kw, dw))
                .add(pkg.TemporalMaxPooling(pool, pool_stride)))
    JaxRNG.set_seed(7)
    jm = build(jnn)
    tm = _carry(jm, build(nn))
    assert tm[0].weight.shape == (kw, 6, 5)        # JAX's (kw, in, out)
    x = _x(2, 9, 6)
    _check(jm, tm, jnp.asarray(x), torch.from_numpy(x).requires_grad_())
    # unbatched (T, F) input
    want = jm.apply(jm.get_params(), jm.get_state(), jnp.asarray(x[0]))[0]
    got = tm(torch.from_numpy(x[0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_text_classifier_matches_jax():
    JaxRNG.set_seed(8)
    jm = JTextClassifier(50, 3, embed_dim=8, seq_len=16, conv_channels=12,
                         kernel_w=3)
    tm = _carry(jm, TextClassifier(50, 3, embed_dim=8, seq_len=16,
                                   conv_channels=12, kernel_w=3,
                                   device="cpu"))
    x = np.random.default_rng(2).integers(0, 50, (4, 16)).astype(np.int32)
    _check(jm, tm, jnp.asarray(x), torch.from_numpy(x), grad_x=False)


@pytest.mark.parametrize("layer", ["Select", "Select-neg", "Squeeze",
                                   "Squeeze-all", "SelectTable",
                                   "SelectTable-neg", "JoinTable",
                                   "JoinTable-batched"])
def test_table_and_shape_layers_match_jax(layer):
    make = {"Select": lambda p: p.Select(2, 3),
            "Select-neg": lambda p: p.Select(-1, -2),
            "Squeeze": lambda p: p.Squeeze(2),
            "Squeeze-all": lambda p: p.Squeeze(),
            "SelectTable": lambda p: p.SelectTable(2),
            "SelectTable-neg": lambda p: p.SelectTable(-1),
            "JoinTable": lambda p: p.JoinTable(2),
            "JoinTable-batched": lambda p: p.JoinTable(1, n_input_dims=2)}
    jm, tm = make[layer](jnn), make[layer](nn)
    shape = (3, 1, 4, 1) if layer.startswith("Squeeze") else (3, 4, 5)
    if "Table" in layer:
        xs = [_x(*shape, seed=s) for s in (1, 2, 3)]
        want = jm.apply({}, {}, JT(*map(jnp.asarray, xs)))[0]
        txs = [torch.from_numpy(a).requires_grad_() for a in xs]
        got = tm(T(*txs))
    else:
        x = _x(*shape)
        want = jm.apply({}, {}, jnp.asarray(x))[0]
        txs = [torch.from_numpy(x).requires_grad_()]
        got = tm(txs[0])
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()        # the gradient reaches the selected inputs
    assert sum(float(t.grad.sum()) for t in txs if t.grad is not None) \
        == pytest.approx(got.numel())
    if layer == "Squeeze":
        with pytest.raises(ValueError, match="size 1"):
            nn.Squeeze(3)(torch.from_numpy(_x(*shape)))


# ------------------------------------------------------------- the tree
def test_tree_model_and_accuracy_match_jax():
    samples = jtree_main.synthetic_trees(6, 5, 30, seed=3)
    ids = np.stack([s.features[0] for s in samples])
    kids = np.stack([s.features[1] for s in samples])
    labels = np.asarray([int(np.asarray(s.labels[0])) for s in samples])
    JaxRNG.set_seed(9)
    jm = jtree_main.build_model(30, 8, 12)
    tm = _carry(jm, tree_main.build_model(30, 8, 12, device="cpu"))
    _check(jm, tm, JT(jnp.asarray(ids), jnp.asarray(kids)),
           T(torch.from_numpy(ids), torch.from_numpy(kids)), grad_x=False)
    # the port's samples are JAX's, draw for draw
    mine = tree_main.synthetic_trees(6, 5, 30, seed=3)
    for a, b in zip(mine, samples):
        for u, v in zip(a.feature + a.label, b.features + b.labels):
            np.testing.assert_array_equal(u, np.asarray(v))
    # TreeNNAccuracy: (N, nodes, classes) read at the root, a per-node
    # target at its first column; host fold, device fold and JAX agree
    out = _x(6, 9, 2, seed=4)
    for target in (labels, np.repeat(labels[:, None], 9, 1)):
        want = joptim.TreeNNAccuracy().apply(out, target, 5)
        got = TreeNNAccuracy().apply(torch.from_numpy(out), target, 5)
        m = TreeNNAccuracy()
        fold = m.finalize(m.device_fold(
            torch.from_numpy(out), torch.from_numpy(target),
            torch.arange(6) < 5))
        assert (got.correct, got.count) == (fold.correct, fold.count) == (
            want.correct, want.count)
    # the validation pass of the main's graph, through the eval program
    from bigdl_tpu_torch.dataset import SampleToMiniBatch
    ds = DataSet.array(mine) >> SampleToMiniBatch(4)
    (res,), _ = run_device_eval(tm, ds, [TreeNNAccuracy()], "cpu")
    with torch.no_grad():
        pred = tm(T(torch.from_numpy(ids), torch.from_numpy(kids)))
    assert res.count == 6
    assert res.correct == float((pred.argmax(-1).numpy() == labels).sum())


# ------------------------------------------------------------- the text
CORPUS = ("the cat sat on the mat\n"
          "the dog sat on the log\n"
          "a cat and a dog met on the mat\n")


def _corpus(tmp_path):
    (tmp_path / "ptb.train.txt").write_text(CORPUS * 12)
    (tmp_path / "ptb.valid.txt").write_text(CORPUS * 3 + "an owl sat\n")
    return tmp_path


def test_dictionary_tokenizer_and_load_ptb_match_jax(tmp_path):
    folder = str(_corpus(tmp_path))
    for split, vocab in (("train", 10000), ("train", 6)):
        want_ids, want_d = jtext.load_ptb(folder, split, vocab_size=vocab)
        ids, d = load_ptb(folder, split, vocab_size=vocab)
        np.testing.assert_array_equal(ids, want_ids)
        assert d._idx2word == want_d._idx2word
    vids, _ = load_ptb(folder, "valid", dictionary=d)
    want_vids, _ = jtext.load_ptb(folder, "valid", dictionary=want_d)
    np.testing.assert_array_equal(vids, want_vids)
    assert d.vocab_size() == len(d) == 6 and d.get_index("owl") == 0
    assert d.get_word(d.get_index("<eos>")) == "<eos>"
    assert d.get_word(99) == "<unk>"
    # the tokenizer and the sentence transformers, as JAX's
    text = ["The Cat's mat, <eos> 42!", "one", "a dog met a cat"]
    tok = list(SentenceTokenizer()(iter(text)))
    assert tok == list(jtext.SentenceTokenizer()(iter(text)))
    full = Dictionary([t for s in tok for t in s])
    want_full = jtext.Dictionary([t for s in tok for t in s])
    assert full._idx2word == want_full._idx2word
    pairs = list(TextToLabeledSentence(full)(iter(tok)))
    want_pairs = list(jtext.TextToLabeledSentence(want_full)(iter(tok)))
    assert len(pairs) == len(want_pairs) == 2       # "one" is dropped
    samples = list(LabeledSentenceToSample()(iter(pairs)))
    for s, (a, b) in zip(samples, want_pairs):
        np.testing.assert_array_equal(s.feature[0], a)
        np.testing.assert_array_equal(s.label[0], b)
    # the synthetic fallback: JAX's corpus and its w{i} dictionary
    ids, d = load_ptb(str(tmp_path / "none"), "train", vocab_size=50,
                      synthetic_size=300)
    want_ids, want_d = jtext.load_ptb(None, "train", vocab_size=50,
                                      synthetic_size=300)
    np.testing.assert_array_equal(ids, want_ids)
    assert d._idx2word == want_d._idx2word and len(d) == 50
    vids, _ = load_ptb(None, "valid", dictionary=d, synthetic_size=300)
    assert vids.max() < 50            # the ids stay inside the dictionary


# ------------------------------------------------------------- the mains
def test_ptb_main_trains_on_a_corpus_file_and_generates(tmp_path, capsys):
    folder = str(_corpus(tmp_path))
    opt = rnn_main.main(["--device", "cpu", "-f", folder, "-b", "4",
                         "--bptt", "6", "--hidden-size", "8",
                         "--generate", "4", "--beam", "2",
                         "--summary-dir", str(tmp_path / "sum")])
    out = capsys.readouterr().out
    assert "final loss:" in out and "perplexity:" in out
    assert np.isfinite(opt.state["loss"]) and "Loss" in opt.state["scores"]
    words, wall = opt.generated
    assert len(words) == max(2, 6 // 4) + 4 and wall > 0
    vocab = set(CORPUS.split()) | {"<eos>", "<unk>"}
    assert set(words) <= vocab and "generated:" in out


@pytest.mark.parametrize("main,argv,score", [
    (tree_main, ["--trees", "40", "--leaves", "4", "-b", "8",
                 "--max-epoch", "1", "--hidden", "8", "--embed-dim", "8"],
     "TreeNNAccuracy"),
    (tc_main, ["--sentences", "40", "-b", "8", "--max-epoch", "1",
               "--seq-len", "16"], "Top1Accuracy"),
], ids=["treelstm", "textclassifier"])
def test_text_mains_run_one_epoch(main, argv, score, capsys):
    opt = main.main(["--device", "cpu", *argv])
    assert np.isfinite(opt.state["loss"])
    assert 0.0 <= opt.state["scores"][score] <= 1.0
    assert "final loss:" in capsys.readouterr().out


def test_lm_main_trains_on_a_corpus_file(tmp_path, capsys):
    path = tmp_path / "corpus.txt"
    path.write_text(CORPUS * 20)
    loss = lm_main.main(["--device", "cpu", "--folder", str(path), "-b", "2",
                         "--seq-len", "8", "--embed-dim", "16",
                         "--num-heads", "2", "--num-layers", "1",
                         "--vocab-size", "16", "--max-iteration", "1"])
    assert np.isfinite(loss) and "final loss:" in capsys.readouterr().out
    assert not hasattr(lm_main, "UNPORTED_FLAGS")


@pytest.mark.parametrize("main", [rnn_main, tree_main, tc_main],
                         ids=["rnn", "treelstm", "textclassifier"])
def test_text_mains_refuse_distributed_and_need_the_card(main, monkeypatch):
    # --distributed is ported (DistriOptimizer): nothing is refused
    assert not hasattr(main, "UNPORTED_FLAGS")
    assert main.build_parser().parse_args(["--distributed"]).distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.main(["--max-epoch", "1"])
