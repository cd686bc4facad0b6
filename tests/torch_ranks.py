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


# --------------------------------------------------- elastic checkpoints
def mlp():
    """The elastic tests' model (JAX's ``tests/test_elastic.py``), its
    initial weights seeded."""
    from bigdl_tpu_torch import nn
    torch.manual_seed(5)
    return (nn.Sequential().add(nn.Linear(8, 16)).add(nn.ReLU())
            .add(nn.Linear(16, 3)).add(nn.LogSoftMax()))


def record_losses(opt) -> list:
    """Every step's loss of ``opt`` from now on, appended to the list."""
    seen: list = []
    run = opt._run_steps

    def recording(batches):
        losses = run(batches)
        seen.extend(losses)
        return losses
    opt._run_steps = recording
    return seen


def elastic_opt(samples, ck=None, every=2, n_iter=4, sync="zero1",
                method=None, rules=None, model=None, backend="elastic",
                batch=16):
    """A DistriOptimizer over ``samples`` (the mesh is the Engine's) with
    an elastic (or pickle) checkpoint every ``every`` iterations."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(5)
    data = DataSet.array([Sample(x, y) for x, y in samples],
                         distributed=True) >> SampleToMiniBatch(batch)
    opt = (DistriOptimizer(model if model is not None else mlp(), data,
                           nn.ClassNLLCriterion(), parameter_sync=sync)
           .set_optim_method(method or SGD(learningrate=0.1, momentum=0.9,
                                           dampening=0.0))
           .set_end_when(Trigger.max_iteration(n_iter)))
    if rules is not None:
        opt.set_tensor_parallel(rules)
    if ck is not None:
        opt.set_checkpoint(ck, Trigger.several_iteration(every),
                           backend=backend)
    return opt


def _params_of(opt) -> dict:
    from bigdl_tpu_torch.dryrun import full_params
    return {n: _np(p).copy() for n, p in full_params(opt).items()}


def _resume(samples, ck, n_iter, init=None, **kw) -> dict:
    """Resume the elastic run under ``ck`` on the Engine's mesh: the
    restored parameters (before training), the continued losses."""
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.utils.robustness import events
    opt = elastic_opt(samples, ck, every=100, n_iter=n_iter, **kw)
    if init is not None:
        convert.load_jax_params(opt.model, init)
    snap = events.snapshot()
    opt._load_latest_checkpoint()
    restored = _params_of(opt)
    losses = record_losses(opt)
    opt.optimize(resume="auto")
    return {"restored": restored, "losses": losses,
            "events": events.deltas(snap)}


def elastic_file(spec: dict) -> dict:
    """Everything ``test_torch_elastic.py`` runs over 4 ranks."""
    import torch.distributed as dist
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import megatron_mlp_rules
    from bigdl_tpu_torch.utils.engine import Engine
    samples, out = spec["samples"], {}
    rank = dist.get_rank()
    # JAX's (2, 4) zero1 version 4, resumed at 4 ranks (data only)
    Engine.reset()
    Engine.init(backend="cpu", mesh_shape=(4,), mesh_axes=("data",))
    out["jax_at_4"] = _resume(samples, spec["jax_ck"][4], 8)
    # the port's tensor-parallel zero1 run on (2, 2), elastic saves
    rules = megatron_mlp_rules("0", "2")
    Engine.reset()
    Engine.init(backend="cpu", mesh_shape=(2, 2),
                mesh_axes=("data", "model"))
    opt = elastic_opt(samples, spec["tp_ck"], rules=rules)
    opt.optimize()
    opt._join_checkpoint_writer()
    dist.barrier()
    out["tp_params"] = _params_of(opt)
    # ... and the same run through the pickle backend (rank 0 gathers)
    opt = elastic_opt(samples, spec["tp_pickle"], rules=rules,
                      backend="pickle", every=4)
    opt.optimize()
    opt._join_checkpoint_writer()
    dist.barrier()
    # the uninterrupted TP run: the continued losses' reference
    opt = elastic_opt(samples, None, n_iter=8, rules=rules)
    out["tp_ref"] = record_losses(opt)
    opt.optimize()
    # the TP version resumed on a mesh without "model" (zero1 over 4)
    Engine.reset()
    Engine.init(backend="cpu", mesh_shape=(4,), mesh_axes=("data",))
    out["tp_at_4"] = _resume(samples, spec["tp_ck"], 8)
    # a pipelined model (2 stages x data 2), elastic and pickle
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.dryrun import leg_model
    Engine.reset()
    Engine.init(backend="cpu", mesh_shape=(2, 2), mesh_axes=("data",
                                                             "pipe"))
    for backend, ck in (("elastic", spec["pp_ck"]),
                        ("pickle", spec["pp_pickle"])):
        m = leg_model("pp", 2)
        convert.load_jax_params(m, spec["pp_init"])
        init = {n: _np(p).copy() for n, p in m.named_parameters()}
        from bigdl_tpu_torch import nn
        opt = elastic_opt(spec["pp_samples"], ck, every=2, n_iter=2,
                          sync="allreduce", model=m, backend=backend,
                          batch=8)
        opt.criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                    size_average=True)
        opt.optimize()
        opt._join_checkpoint_writer()
        dist.barrier()
    m = leg_model("pp", 2)
    convert.load_jax_params(m, spec["pp_init"])
    opt = elastic_opt(spec["pp_samples"], None, n_iter=4, sync="allreduce",
                      model=m, batch=8)
    opt.criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                size_average=True)
    out["pp_ref"] = record_losses(opt)
    opt.optimize()
    out["rank"] = rank
    return out


def elastic_two(spec: dict) -> dict:
    """``test_torch_elastic.py``'s 2-rank resumes: JAX's (2, 4) version
    and the port's TP version at data 2."""
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.reset()
    Engine.init(backend="cpu", mesh_shape=(2,), mesh_axes=("data",))
    return {"jax_at_2": _resume(spec["samples"], spec["jax_ck"][2], 8)}


# ------------------------------------------------------ the host-loss drill
def _watch_peer(peer_pid: int, argv: list) -> None:
    """Poll the peer; when it is gone, re-execute this process in the
    survivor's mode (a real elastic controller restarts the trainer on the
    shrunk topology; the dead peer leaves the process group unusable)."""
    import os
    import sys
    import time
    env = dict(os.environ, BIGDL_DRILL_MODE="drill_resume")
    env.pop("BIGDL_FAULT_PLAN", None)
    while True:
        try:
            os.kill(peer_pid, 0)
        except OSError:
            sys.stderr.write(f"peer {peer_pid} is gone: re-executing for "
                             f"the world-1 elastic resume\n")
            sys.stderr.flush()
            os.execve(sys.executable,
                      [sys.executable, os.path.abspath(__file__)] + argv,
                      env)
        time.sleep(0.05)


def _drill_samples():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(8,)).astype(np.float32),
             np.int32(rng.integers(0, 3))) for _ in range(64)]


def drill_main(argv: list) -> None:
    """The host-loss drill's process: ``drill`` (2 gloo ranks, zero1,
    elastic saves every 2 iterations; ``host_down`` kills rank 1 by the
    environment's fault plan; rank 0 watches its peer) or
    ``drill_resume`` (world 1: the restored leaves checked bitwise against
    the newest complete version, then trained to the end). Writes a JSON
    result to ``argv[2]``."""
    import json
    import os
    import threading
    port, rank, out_file = argv[0], int(argv[1]), argv[2]
    mode = os.environ.get("BIGDL_DRILL_MODE", "drill")
    torch.set_num_threads(1)
    from bigdl_tpu_torch.utils import elastic_ckpt
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.robustness import events
    ck, iters = os.environ["BIGDL_DRILL_DIR"], 8
    if mode == "drill_resume":
        Engine.init(backend="cpu")
        snap = events.snapshot()
        opt = elastic_opt(_drill_samples(), ck, n_iter=iters)
        versions = elastic_ckpt.complete_versions(ck)
        saved, _, _ = elastic_ckpt.assemble(os.path.join(
            ck, elastic_ckpt.version_dirname(versions[-1])))
        opt._load_latest_checkpoint()
        from bigdl_tpu_torch import convert
        flat = convert.flatten_tree(saved["params"])
        bitwise = all(np.array_equal(_np(p), flat[n])
                      for n, p in opt.model.named_parameters())
        resumed_from = int(opt.state["neval"])
        losses = record_losses(opt)
        opt.optimize(resume="auto")
        deltas = events.deltas(snap)
        with open(out_file, "w") as f:
            json.dump({"mode": mode, "resumed_from": resumed_from,
                       "bitwise_equal": bool(bitwise), "losses": losses,
                       "neval": int(opt.state["neval"]),
                       "versions_seen": versions,
                       "elastic_resume_events":
                           int(deltas.get("elastic_resume", 0)),
                       "world": Engine.mesh().size}, f)
        return
    Engine.init(backend="cpu", coordinator_address=f"localhost:{port}",
                process_id=rank, node_number=2)
    if rank == 0:
        threading.Thread(target=_watch_peer,
                         args=(int(os.environ["BIGDL_DRILL_PEER"]), argv),
                         daemon=True).start()
    opt = elastic_opt(_drill_samples(), ck, n_iter=iters)
    try:
        opt.optimize()
    except RuntimeError:
        if rank == 0:
            # gloo saw the peer go first: the watcher re-executes this
            # process once the peer is gone for good
            import time
            time.sleep(60)
        raise
    with open(out_file, "w") as f:
        json.dump({"mode": mode, "completed": True}, f)


# ------------------------------------------ the trainer's configurations
def configs_file(spec: dict) -> dict:
    """Everything ``test_torch_distributed_configs.py`` runs over 4
    ranks: LarsSGD and LBFGS under zero1 and fsdp at data 4 and 2, fsdp's
    bytes, bf16 GPipe."""
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.optim.optim_method import LBFGS, LarsSGD
    from bigdl_tpu_torch.utils.engine import Engine
    out = {}
    for d in (4, 2):
        Engine.reset()
        Engine.init(backend="cpu", mesh_shape=(d, 4 // d),
                    mesh_axes=("data", "model"))
        for name in ("lars", "lbfgs"):
            for sync in ("zero1", "fsdp"):
                method = (LarsSGD(learningrate=0.1, weightdecay=1e-3)
                          if name == "lars" else
                          LBFGS(history=4, learningrate=0.5))
                m = mlp()
                convert.load_jax_params(m, spec["init"])
                opt = elastic_opt(spec["samples"], None, n_iter=3,
                                  sync=sync, method=method, model=m)
                losses = record_losses(opt)
                seen = []
                if sync == "fsdp":
                    run = opt._run_steps

                    def with_bytes(batches, run=run, opt=opt, seen=seen):
                        r = run(batches)
                        seen.append(opt.fsdp_bytes())
                        return r
                    opt._run_steps = with_bytes
                opt.optimize()
                out[f"{name}/{sync}/{d}"] = {
                    "losses": list(losses), "bytes": seen,
                    "params": {n: _np(p).copy()
                               for n, p in m.named_parameters()}}
    # bf16 GPipe (the LM leg's 2 stages on data 2 x pipe 2) and its fp32
    # twin
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dryrun import leg_model
    from bigdl_tpu_torch.optim import SGD
    for dtype in (torch.bfloat16, torch.float32):
        Engine.reset()
        Engine.init(backend="cpu", mesh_shape=(2, 2),
                    mesh_axes=("data", "pipe"), compute_dtype=dtype)
        m = leg_model("pp", 2)
        convert.load_jax_params(m, spec["pp_init"])
        init = {n: _np(p).copy() for n, p in m.named_parameters()}
        opt = elastic_opt(spec["pp_samples"], None, n_iter=2,
                          sync="allreduce", model=m, batch=8,
                          method=SGD(learningrate=0.05, momentum=0.9,
                                     dampening=0.0))
        opt.criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                                    size_average=True)
        losses = record_losses(opt)
        # the dtypes this rank's stage computed in: each module that holds
        # parameters, by its output (containers call ``run``, not hooks)
        computed = set()
        for mod in m.modules():
            if any(True for _ in mod.parameters(recurse=False)):
                def run(x, state=None, _run=mod.run):
                    y, s = _run(x, state)
                    computed.add(str(y.dtype))
                    return y, s
                mod.run = run
        opt.optimize()
        out[f"gpipe/{dtype}"] = {
            "loss": losses[-1], "losses": list(losses),
            "computed": sorted(computed), "init": init,
            "params": {n: _np(p).copy() for n, p in m.named_parameters()}}
    Engine.reset()
    return out


if __name__ == "__main__":
    import sys
    sys.path.insert(0, __import__("os").path.dirname(
        __import__("os").path.dirname(__import__("os").path.abspath(
            __file__))))
    drill_main(sys.argv[1:])
