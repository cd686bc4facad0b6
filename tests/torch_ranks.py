"""Rank-side functions of the port's multi-rank CPU tests.

``tests/test_torch_distributed.py``, ``test_torch_tensor_parallel.py`` and
``test_torch_pipeline.py`` spawn 4 gloo ranks once per file
(``bigdl_tpu_torch.dryrun.spawn``); each rank runs one of these functions
and returns numpy results, which the test compares with JAX in its own
process. This module imports only the port (the ranks never load JAX).
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def run_legs(legs: dict) -> dict:
    """``{key: (leg, variant, init, samples, iterations)}`` -> each leg's
    ``run_leg`` result (loss, whole parameters, extras)."""
    from bigdl_tpu_torch.dryrun import run_leg
    return {key: run_leg(leg, 4, variant, init=init, samples=samples,
                         iterations=iters, backend="cpu")
            for key, (leg, variant, init, samples, iters) in legs.items()}


def bn_model(sync: bool):
    from bigdl_tpu_torch import nn
    return (nn.Sequential().add(nn.SpatialBatchNormalization(3, sync=sync))
            .add(nn.Reshape([48])).add(nn.Linear(48, 2))
            .add(nn.LogSoftMax()))


def _train(model, samples, batch, crit, sync="allreduce", iters=1,
           lr=0.1, momentum=0.0, ckpt=None, val=None, fuse=1):
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(1)        # JAX's Engine.init seeds it so
    data = DataSet.array([Sample(x, y) for x, y in samples],
                         distributed=True) >> SampleToMiniBatch(batch)
    opt = (DistriOptimizer(model, data, crit, parameter_sync=sync)
           .set_optim_method(SGD(learningrate=lr, momentum=momentum,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(iters)))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.several_iteration(iters))
    if val is not None:
        from bigdl_tpu_torch.optim import Loss, Top1Accuracy
        opt.set_validation(
            Trigger.several_iteration(iters),
            DataSet.array([Sample(x, y) for x, y in val])
            >> SampleToMiniBatch(batch), [Top1Accuracy(), Loss()])
    opt.set_fuse_steps(fuse)
    opt.optimize()
    return opt


def padding_criterion(kind: str, pkg):
    """One of the three criteria that divide by a count of valid rows,
    from ``pkg`` (the port's ``nn`` or JAX's): ``"mask"``
    (``TimeDistributedMaskCriterion``, padding 0), ``"softmax"``
    (``SoftmaxWithCriterion``, ignore 255, ``valid``) or ``"chunked"``
    (``ChunkedSoftmaxCrossEntropy``, labels outside [0, V) invalid)."""
    if kind == "mask":
        return pkg.TimeDistributedMaskCriterion(pkg.ClassNLLCriterion(),
                                                padding_value=0)
    if kind == "softmax":
        return pkg.SoftmaxWithCriterion(ignore_label=255,
                                        normalize_mode="valid")
    return pkg.ChunkedSoftmaxCrossEntropy(chunk_size=2)


def padding_loss(kind: str, x: torch.Tensor, y, head=None):
    """The port's ``padding_criterion(kind)`` on ``x`` (log-probabilities,
    logits, or hidden states with ``head`` = (weight, bias)) and labels
    ``y``."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils.table import Table
    inp = x if head is None else Table(x, *(torch.from_numpy(h)
                                            for h in head))
    return padding_criterion(kind, nn).forward(inp, torch.from_numpy(y))


def padding_cases(cases: dict) -> dict:
    """Ranks 0 and 1 as a data-parallel group of 2: each case's loss and
    input gradient on the rank's block (``{key: (kind, xs, ys, head)}``,
    ``xs[r]``/``ys[r]`` rank ``r``'s block)."""
    import torch.distributed as dist
    from bigdl_tpu_torch.parallel import collectives as C
    group = dist.new_group([0, 1])
    r = dist.get_rank()
    if r > 1:
        return {}
    out = {}
    for key, (kind, xs, ys, head) in cases.items():
        x = torch.from_numpy(xs[r]).requires_grad_(True)
        with C.data_parallel(group):
            loss = padding_loss(kind, x, ys[r], head)
        loss.backward()
        out[key] = (float(loss.detach()), _np(x.grad))
    return out


def distributed_file(spec: dict) -> dict:
    """Everything ``test_torch_distributed.py`` runs over 4 ranks."""
    from bigdl_tpu_torch import convert, nn
    from bigdl_tpu_torch.utils.engine import Engine
    out = {"legs": run_legs(spec["legs"])}
    Engine.reset()
    Engine.init(backend="cpu")
    # batch norm's running statistics after a data-parallel step
    for sync in (False, True):
        m = bn_model(sync)
        convert.load_jax_params(m, spec["bn_init"])
        _train(m, spec["bn_samples"], 16, nn.ClassNLLCriterion())
        out[f"bn_sync={sync}"] = {"mean": _np(m[0].running_mean),
                                  "var": _np(m[0].running_var),
                                  "params": {n: _np(p) for n, p in
                                             m.named_parameters()}}
    # criteria whose count is 0 on one rank or on every rank
    out["padding"] = padding_cases(spec["padding"])
    # a criterion whose count differs per rank (ignored labels)
    m = nn.Sequential().add(nn.Linear(6, 5)).add(nn.LogSoftMax())
    convert.load_jax_params(m, spec["ign_init"])
    crit = nn.TimeDistributedMaskCriterion(nn.ClassNLLCriterion(),
                                           padding_value=0)
    opt = _train(m, spec["ign_samples"], 8, crit)
    out["ignored"] = {"loss": opt.state["loss"],
                      "params": {n: _np(p) for n, p in m.named_parameters()}}
    # a ZeRO-1 checkpoint written at world 4 (rank 0 writes)
    for sync in ("zero1", "fsdp"):
        m = nn.Sequential().add(nn.Linear(8, 12)).add(nn.Tanh()) \
            .add(nn.Linear(12, 3)).add(nn.LogSoftMax())
        convert.load_jax_params(m, spec["ckpt_init"])
        opt = _train(m, spec["ckpt_samples"], 8, nn.ClassNLLCriterion(),
                     sync=sync, iters=2, lr=0.05, momentum=0.9,
                     ckpt=spec["ckpt_dir"] + "/" + sync,
                     val=spec["ckpt_samples"][:12])
        out[f"ckpt_{sync}"] = {"loss": opt.state["loss"],
                               "scores": dict(opt.state["scores"]),
                               "shards": sorted(opt._shards),
                               "params": {n: _np(p) for n, p in
                                          m.named_parameters()}}
    # a fused window of 2 steps: the per-step run's losses and weights
    runs = {}
    for fuse in (1, 2):
        m = nn.Sequential().add(nn.Linear(8, 12)).add(nn.Tanh()) \
            .add(nn.Linear(12, 3)).add(nn.LogSoftMax())
        convert.load_jax_params(m, spec["ckpt_init"])
        opt = _train(m, spec["ckpt_samples"], 4, nn.ClassNLLCriterion(),
                     sync="zero1", iters=4, lr=0.05, momentum=0.9,
                     fuse=fuse)
        runs[fuse] = (opt.state["loss"],
                      {n: _np(p) for n, p in m.named_parameters()})
    out["fused"] = runs
    # dropout draws per rank: the same weights, different masks
    m = nn.Sequential().add(nn.Dropout(0.5))
    g = torch.Generator().manual_seed(0)
    m[0].generator = g
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    opt = DistriOptimizer(m, None, nn.MSECriterion(), device="cpu")
    opt._setup()
    from bigdl_tpu_torch.parallel import collectives as C
    mask = (m.train()(torch.ones(64)) > 0).float()
    out["dropout_masks"] = _np(C.all_gather_cat(mask[None], None, 0))
    return out


def tensor_parallel_file(spec: dict) -> dict:
    """Everything ``test_torch_tensor_parallel.py`` runs over 4 ranks."""
    from bigdl_tpu_torch import convert, nn
    from bigdl_tpu_torch.parallel import (
        TPRules, embedding_parallel_rules, ring_attention,
    )
    from bigdl_tpu_torch.utils.engine import Engine
    out = {"legs": run_legs(spec["legs"])}
    # ring attention against the whole sequence, sp = 2 and 4
    q, k, v, dout = (torch.from_numpy(a) for a in spec["qkvd"])
    for shape in ((2, 2), (1, 4)):
        Engine.reset()
        Engine.init(backend="cpu", mesh_shape=shape,
                    mesh_axes=("data", "seq"))
        for causal in (False, True):
            qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
            o = ring_attention(qq, kk, vv, causal=causal)
            o.backward(dout)
            out[f"ring_sp{shape[1]}_causal={causal}"] = [
                _np(t) for t in (o, qq.grad, kk.grad, vv.grad)]
    # a vocab-parallel table (embedding_parallel_rules) in a dp x tp step
    Engine.reset()
    Engine.init(backend="cpu", mesh_shape=(2, 2),
                mesh_axes=("data", "model"))
    from bigdl_tpu_torch.parallel import ShardedEmbedding
    m = (nn.Sequential()
         .add(ShardedEmbedding(nn.LookupTable(16, 6, zero_based=True)))
         .add(nn.Select(2, -1)).add(nn.Linear(6, 3)).add(nn.LogSoftMax()))
    convert.load_jax_params(m, spec["emb_init"])
    opt = _train_tp(m, spec["emb_samples"], embedding_parallel_rules())
    from bigdl_tpu_torch.dryrun import full_params
    out["embedding"] = {"loss": opt.state["loss"],
                        "params": {n: _np(p) for n, p in
                                   full_params(opt).items()}}
    # MoE routing with drops on several ranks (skewed gate, capacity 0.5):
    # dp 4, and dp 2 x ep 2
    from bigdl_tpu_torch.parallel import MoE, expert_parallel_rules
    for key, (router, (shape, axes), init, samples) in spec["moe"].items():
        Engine.reset()
        Engine.init(backend="cpu", mesh_shape=shape, mesh_axes=axes)
        m = (nn.Sequential()
             .add(MoE(8, 16, n_experts=4, router=router,
                      capacity_factor=0.5, z_loss_weight=1e-3))
             .add(nn.Linear(8, 3)).add(nn.LogSoftMax()))
        convert.load_jax_params(m, init)
        rules = expert_parallel_rules("0") if "model" in axes else None
        opt = _train_tp(m, samples, rules, batch=16, aux=0.01)
        out[f"moe/{key}"] = {
            "loss": opt.state["loss"],
            "params": {n: _np(p) for n, p in full_params(opt).items()},
            **{leaf: _np(getattr(m[0], leaf)) for leaf in (
                "dropped_fraction", "expert_load", "aux_loss")}}
    # a rule that matches a leaf no parallel form covers
    m = nn.Sequential().add(nn.SpatialConvolution(2, 4, 3, 3))
    try:
        _train_tp(m, [(np.zeros((2, 5, 5), np.float32),
                       np.zeros((4, 3, 3), np.float32))] * 4,
                  TPRules([(r"0/weight$", ("model", None, None, None))]),
                  crit=nn.MSECriterion())
        out["uncovered"] = None
    except ValueError as e:
        out["uncovered"] = str(e)
    return out


def _train_tp(model, samples, rules, crit=None, batch=4, aux=None):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(1)        # JAX's Engine.init seeds it so
    data = DataSet.array([Sample(x, y) for x, y in samples],
                         distributed=True) >> SampleToMiniBatch(batch)
    opt = (DistriOptimizer(model, data, crit or nn.ClassNLLCriterion())
           .set_optim_method(SGD(learningrate=0.1, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(2)))
    if rules is not None:
        opt.set_tensor_parallel(rules)
    if aux is not None:
        opt.set_aux_loss_weight(aux)
    opt.optimize()
    return opt


def pipeline_file(spec: dict) -> dict:
    """Everything ``test_torch_pipeline.py`` runs over 4 ranks."""
    from bigdl_tpu_torch import convert, nn
    from bigdl_tpu_torch.dryrun import leg_model
    from bigdl_tpu_torch.utils.engine import Engine
    out = {"legs": run_legs(spec["legs"])}
    # one pipelined step's gradients under both schedules, dp 1 x pp 4 and
    # dp 2 x pp 2, from the same weights
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    x, y = (torch.from_numpy(a) for a in spec["xy"])
    for shape, init_key in (((1, 4), "init4"), ((2, 2), "init2")):
        Engine.reset()
        Engine.init(backend="cpu", mesh_shape=shape,
                    mesh_axes=("data", "pipe"))
        mesh = Engine.mesh()
        d, i = shape[0], mesh.index("data")
        xb = x.chunk(d, 0)[i]
        yb = y.chunk(d, 0)[i]
        for schedule in ("gpipe", "1f1b"):
            m = leg_model("pp", shape[1], schedule=schedule)
            convert.load_jax_params(m, spec[init_key])
            loss, grads = m.pipeline_train_step(xb, yb, crit)
            from bigdl_tpu_torch.parallel import collectives as C
            grads = {n: C.all_reduce_(g.clone(), mesh.group("data")) / d
                     for n, g in grads.items()}
            loss = C.all_reduce_(loss.clone(), mesh.group("data")) / d
            gathered = {}
            for s in range(m.n_stages):
                for n, p in m[s].named_parameters():
                    key = f"{s}.{n}"
                    t = grads.get(key, torch.zeros_like(p)).contiguous()
                    C.broadcast_(t, mesh.group_ranks("pipe")[s],
                                 mesh.group("pipe"))
                    gathered[key] = _np(t)
            out[f"{schedule}_pp{shape[1]}"] = {"loss": float(loss),
                                               "grads": gathered}
        if shape[1] == 4:
            # the pipelined forward (inference) against the stages in a row
            m = leg_model("pp", 4)
            convert.load_jax_params(m, spec[init_key])
            with torch.no_grad():
                out["forward_pp4"] = _np(m.eval()(xb))
    return out


#: each training main at a small size (``--device cpu`` added; the
#: same arguments go to JAX's main)
MAINS = {
    "autoencoder": ["-b", "32", "--synthetic-size", "64"],
    "inception": ["-b", "2", "--classes", "3", "--no-aux", "--max-iteration",
                  "1", "--synthetic-size", "2", "--image-size", "224"],
    "lenet": ["-b", "16", "--synthetic-size", "32"],
    "ncf": ["-b", "64", "--interactions", "96", "--max-epoch", "1",
            "--user-count", "20", "--item-count", "12", "--eval-neg-num",
            "5", "--k", "3", "--sharded"],
    "resnet": ["--depth", "8", "--synthetic-size", "32", "-b", "16"],
    "rnn": ["-b", "64", "--vocab-size", "40", "--hidden-size", "8",
            "--num-layers", "1", "--bptt", "20"],
    "ssd": ["-b", "4", "--img-size", "32", "--max-epoch", "1",
            "--n-train", "8"],
    "textclassifier": ["-b", "16", "--sentences", "40", "--max-epoch", "1",
                       "--seq-len", "32", "--vocab-size", "50"],
    "transformer": ["-b", "8", "--synthetic-size", "16", "--max-epoch", "1",
                    "--embed-dim", "16", "--num-heads", "2",
                    "--num-encoder-layers", "1", "--num-decoder-layers",
                    "1"],
    "transformerlm": ["-b", "4", "--seq-len", "16", "--embed-dim", "32",
                      "--num-heads", "2", "--vocab-size", "64",
                      "--max-iteration", "2", "--synthetic-tokens", "2000"],
    "treelstm": ["-b", "8", "--trees", "20", "--max-epoch", "1",
                 "--leaves", "4", "--hidden", "8", "--embed-dim", "8"],
    "vgg": ["--synthetic-size", "8", "-b", "8"],
    "widedeep": ["-b", "32", "--examples", "72", "--max-epoch", "1"],
}


def _from_jax(build, tree: dict, dropouts: list):
    """``build`` returning its model with JAX's weights and state
    (``tree``) loaded and every dropout off (their count appended to
    ``dropouts``)."""
    from bigdl_tpu_torch import convert, nn

    def built(*args, **kwargs):
        m = build(*args, **kwargs)
        convert.load_jax_params(m, tree["params"])
        convert.load_jax_state(m, tree["state"])
        drops = [d for d in m.modules() if isinstance(d, nn.Dropout)]
        for d in drops:
            d.set_p(0.0)
        dropouts.append(len(drops))
        return m
    return built


def run_mains(distributed: bool, names=None, models=None) -> dict:
    """Each main of :data:`MAINS` (``--distributed`` when asked), on one
    intra-op thread: ``{"losses": the loss of every iteration,
    "dropouts": dropout layers switched off}``. ``models`` maps a main to
    ``(module, constructor, tree)``: the main's model is then built by
    ``bigdl_tpu_torch.models.<module>.<constructor>`` and given JAX's
    weights ``tree`` (``{"params", "state"}``), dropout off."""
    import importlib
    import io
    from contextlib import redirect_stdout
    from bigdl_tpu_torch.optim.optimizer import Optimizer
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    seen: list = []
    run_steps = Optimizer._run_steps

    def recording(self, batches):
        losses = run_steps(self, batches)
        seen.extend(losses)
        return losses

    Optimizer._run_steps = recording
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name in names or MAINS:
            seen.clear()
            RandomGenerator.set_seed(1)
            torch.manual_seed(0)
            main = importlib.import_module(
                f"bigdl_tpu_torch.models.{name}.train")
            argv = ["--device", "cpu", *MAINS[name]]
            if distributed:
                argv.append("--distributed")
            patched, dropouts = None, []
            if models and name in models:
                module, ctor, tree = models[name]
                pkg = importlib.import_module(
                    f"bigdl_tpu_torch.models.{module}")
                patched = (pkg, ctor, getattr(pkg, ctor))
                setattr(pkg, ctor, _from_jax(patched[2], tree, dropouts))
            try:
                with redirect_stdout(io.StringIO()):
                    main.main(argv)
            finally:
                if patched is not None:
                    setattr(*patched)
            out[name] = {"losses": list(seen),
                         "dropouts": dropouts[0] if dropouts else None}
    finally:
        Optimizer._run_steps = run_steps
        torch.set_num_threads(threads)
    return out
