"""The flagship model's forward (``entry()``) and the multi-rank dry run
(``dryrun_multichip``).

Counterpart of ``bigdl_tpu/dryrun.py``: ``entry`` is the TransformerLM
family's forward step and example arguments, on the card unless the caller
passes ``device="cpu"``; ``dryrun_multichip(n)`` trains one step of each
of JAX's mesh legs over ``n`` ranks (:func:`spawn` starts them when no
launcher did) and prints the losses keyed as JAX keys them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call


def entry(device=None):
    """``(forward, (params, tokens))`` on the flagship
    ``TransformerLM(1024, 256, 4, 2, max_len=256)`` in eval mode:
    ``forward(params, tokens)`` runs the model on ``params`` (a dict of
    tensors by parameter path, the JAX ``get_params()`` paths flattened)
    and returns the (4, 256, 1024) log-probs of ``tokens``."""
    from bigdl_tpu_torch.models.transformerlm import TransformerLM

    model = TransformerLM(vocab_size=1024, embed_dim=256, num_heads=4,
                          num_layers=2, max_len=256, dropout=0.0,
                          device=device).evaluate()
    params = {n: p.detach() for n, p in model.named_parameters()}

    def forward(params, tokens):
        return functional_call(model, params, (tokens,))

    tokens = torch.zeros((4, 256), dtype=torch.long,
                         device=next(iter(params.values())).device)
    return forward, (params, tokens)


# ------------------------------------------------------------ the mesh run
#: the legs of ``dryrun_multichip`` (``bigdl_tpu/dryrun.py:50-257``)
LEGS = ("dp", "tp", "ep", "pp", "sp")


def leg_samples(leg: str, n: int) -> list:
    """JAX's data of a leg at ``n`` ranks: ``(feature, label)`` numpy
    pairs drawn as ``bigdl_tpu/dryrun.py`` draws them."""
    import numpy as np
    if leg == "dp":
        from bigdl_tpu_torch.dataset.mnist import load_mnist
        from bigdl_tpu_torch.dataset.mnist import to_samples
        imgs, labels = load_mnist(None, "train", synthetic_size=4 * n)
        return [(s.feature, s.label) for s in to_samples(imgs, labels)]
    if leg == "tp":
        rng = np.random.default_rng(0)
        return [(rng.normal(size=(16,)).astype(np.float32),
                 np.int32(rng.integers(0, 4))) for _ in range(4 * n)]
    if leg == "ep":
        rng = np.random.default_rng(2)
        return [(rng.normal(size=(8,)).astype(np.float32),
                 np.int32(rng.integers(0, 3))) for _ in range(4 * n)]
    if leg == "pp":
        rng = np.random.default_rng(3)
        return [(rng.integers(0, 32, size=(8,)).astype(np.int32),
                 rng.integers(0, 32, size=(8,)).astype(np.int32))
                for _ in range(4 * n)]
    if leg == "sp":
        rng = np.random.default_rng(1)
        t = 2 * n
        return [(rng.normal(size=(t, 8)).astype(np.float32),
                 np.int32(rng.integers(0, 4))) for _ in range(8)]
    raise ValueError(f"unknown leg {leg!r}")


def _pp_size(n: int) -> int:
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def leg_model(leg: str, n: int, schedule: str = "gpipe"):
    """A leg's model as JAX's dryrun builds it (on the CPU)."""
    from bigdl_tpu_torch import nn
    if leg == "dp":
        from bigdl_tpu_torch.models.lenet import LeNet5
        return LeNet5(10, device="cpu")
    if leg == "tp":
        tp = 2
        return (nn.Sequential().add(nn.Linear(16, 4 * tp)).add(nn.ReLU())
                .add(nn.Linear(4 * tp, 4)).add(nn.LogSoftMax()))
    if leg == "ep":
        from bigdl_tpu_torch.parallel import MoE
        return (nn.Sequential()
                .add(MoE(8, 16, n_experts=4, router="top2",
                         z_loss_weight=1e-3))
                .add(nn.Linear(8, 3)).add(nn.LogSoftMax()))
    if leg == "pp":
        from bigdl_tpu_torch.models.transformerlm.transformerlm import (
            PositionEmbedding, TransformerBlock,
        )
        from bigdl_tpu_torch.parallel import GPipe
        pp, vocab, dim, seq = _pp_size(n), 32, 16, 8
        embed = (nn.Sequential()
                 .add(nn.LookupTable(vocab, dim, zero_based=True))
                 .add(PositionEmbedding(seq, dim)))
        # head dim 8 is below the flash kernel's smallest (32): these toy
        # blocks attend through the plain full_attention, which is what
        # JAX's "auto" computes for them
        blocks = [TransformerBlock(dim, num_heads=2, dropout=0.0,
                                   attention_impl="full")
                  for _ in range(pp - 2)]
        head = (nn.Sequential().add(nn.LayerNorm(dim))
                .add(nn.TimeDistributed(nn.Linear(dim, vocab)))
                .add(nn.TimeDistributed(nn.LogSoftMax())))
        return GPipe(stages=[embed] + blocks + [head], n_microbatches=2,
                     schedule=schedule)
    if leg == "sp":
        return (nn.Sequential()
                .add(nn.MultiHeadAttention(8, 2, causal=True,
                                           attention_impl="ring"))
                .add(nn.Select(2, -1))
                .add(nn.Linear(8, 4)).add(nn.LogSoftMax()))
    raise ValueError(f"unknown leg {leg!r}")


def leg_mesh(leg: str, n: int):
    """(mesh_shape, mesh_axes) of a leg at ``n`` ranks, JAX's."""
    if leg == "dp":
        return (n,), ("data",)
    if leg in ("tp", "ep"):
        return (n // 2, 2), ("data", "model")
    if leg == "pp":
        pp = _pp_size(n)
        return (n // pp, pp), ("data", "pipe")
    sp = n // 2 if n % 2 == 0 else n
    return (n // sp, sp), ("data", "seq")


def run_leg(leg: str, n: int, variant: str = "", init=None, samples=None,
            iterations: int = 1, backend: Optional[str] = None) -> dict:
    """One leg of ``dryrun_multichip`` on this rank: the Engine mesh of the
    leg, its model (from ``init``, JAX's params tree, when given) trained
    ``iterations`` steps of SGD(0.05, momentum 0.9) by ``DistriOptimizer``
    on ``samples`` (default: JAX's); returns the loss, the parameters
    (whole: split leaves gathered) and the leg's extras as numpy."""
    import numpy as np
    import torch

    from bigdl_tpu_torch import convert, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    shape, axes = leg_mesh(leg, n)
    Engine.reset()
    Engine.init(backend=backend, mesh_shape=shape, mesh_axes=axes)
    RandomGenerator.set_seed(1)
    torch.manual_seed(1)
    model = leg_model(leg, n, schedule=variant or "gpipe")
    if init is not None:
        convert.load_jax_params(model, init)
    model = model.to(Engine.device())
    pairs = samples if samples is not None else leg_samples(leg, n)
    batch = {"dp": 4 * n, "tp": 2 * n, "ep": 2 * n, "pp": 2 * n,
             "sp": 4}[leg]
    data = DataSet.array([Sample(x, y) for x, y in pairs],
                         distributed=True) >> SampleToMiniBatch(batch)
    if leg == "pp":
        crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                           size_average=True)
    else:
        crit = nn.ClassNLLCriterion()
    sync = variant if leg == "dp" else ("zero1" if leg in ("tp", "ep")
                                        else "allreduce")
    opt = (DistriOptimizer(model, data, crit, parameter_sync=sync)
           .set_optim_method(SGD(learningrate=0.05, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(iterations)))
    if leg == "tp":
        from bigdl_tpu_torch.parallel import megatron_mlp_rules
        opt.set_tensor_parallel(megatron_mlp_rules("0", "2"))
    if leg == "ep":
        from bigdl_tpu_torch.parallel import expert_parallel_rules
        opt.set_tensor_parallel(expert_parallel_rules("0"))
        opt.set_aux_loss_weight(0.01)
    opt.optimize()
    out = {"loss": float(opt.state["loss"]), "step_mode": opt.step_mode,
           "params": {k: v.detach().cpu().numpy()
                      for k, v in full_params(opt).items()}}
    if leg == "ep":
        out["dropped_fraction"] = float(model[0].dropped_fraction)
        out["aux_loss"] = float(model[0].aux_loss)
    return out


def full_params(opt) -> dict:
    """The trained parameters by path, leaves split over the ``model``
    axis gathered whole (every rank of the slice takes part)."""
    import torch
    from bigdl_tpu_torch.parallel import collectives as C
    out = {}
    for name, p in opt.model.named_parameters():
        split = opt._tp_split.get(name)
        if split is None:
            out[name] = p.detach()
        else:
            dim, axis = split
            out[name] = C.all_gather_cat(p.detach(), opt._mesh.group(axis),
                                         dim)
    return out


def leg_key(leg: str, variant: str, n: int) -> str:
    """A leg's key in the losses, as JAX prints it."""
    if leg == "dp":
        return f"dp/{variant}"
    if leg == "tp":
        return "dp x tp/zero1"
    if leg == "ep":
        return "dp x ep/moe"
    if leg == "pp":
        return ("dp x pp/1f1b-hetero-lm" if variant == "1f1b"
                else "dp x pp/gpipe-hetero-lm")
    sp = n // 2 if n % 2 == 0 else n
    return f"dp{n // sp} x sp{sp}/ring-attention"


def all_legs(n: int) -> list:
    """(leg, variant) of every run of ``dryrun_multichip(n)``, JAX's
    order."""
    runs = [("dp", s) for s in ("allreduce", "zero1", "fsdp")]
    if n % 2 == 0:
        runs += [("tp", ""), ("ep", "")]
    if _pp_size(n) > 1:
        runs += [("pp", "gpipe"), ("pp", "1f1b")]
    return runs + [("sp", "")]


def _legs_main(n: int, backend: Optional[str]) -> dict:
    losses, modes = {}, set()
    for leg, variant in all_legs(n):
        r = run_leg(leg, n, variant, backend=backend)
        losses[leg_key(leg, variant, n)] = r["loss"]
        modes.add(r["step_mode"])
        if leg == "ep":
            losses["dp x ep/moe_dropped_fraction"] = r["dropped_fraction"]
    return {"losses": losses, "step_modes": sorted(modes)}


def _rank_entry(rank: int, n: int, address: str, backend, fn, args, queue):
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank))
    import torch
    torch.set_num_threads(1)
    from bigdl_tpu_torch.utils.engine import Engine
    try:
        Engine.init(backend=backend, coordinator_address=address,
                    process_id=rank, node_number=n)
        result = fn(*args)
        queue.put((rank, "ok", result))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback
        queue.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1) from e
    finally:
        Engine.shutdown_distributed(timeout=30)


def spawn(fn, n: int, args=(), backend: Optional[str] = None,
          timeout: float = 600.0, workdir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` on ``n`` fresh ranks (one process each, one
    intra-op thread, a ``FileStore`` under ``workdir``) and return every
    rank's result in rank order; a rank's failure raises with its
    traceback. ``fn`` must be importable by name."""
    import multiprocessing as mp
    import os
    import queue as queue_mod
    import tempfile
    import time
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="bigdl-spawn-", dir=workdir)
    address = "file://" + os.path.join(tmp, "store")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, n, address, backend, fn, args, q),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            try:
                rank, status, value = q.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that died without reporting (an abort) ends the run
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       f"result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawned ranks did not finish "
                                       f"within {timeout:.0f} s") from None
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(n)]


def dryrun_multichip(n_devices: int, backend: Optional[str] = None) -> dict:
    """Every leg of JAX's ``dryrun_multichip`` (``bigdl_tpu/dryrun.py:
    50-257``) over ``n_devices`` ranks: data parallelism in ``allreduce``,
    ``zero1`` and ``fsdp``; dp x tp (``megatron_mlp_rules("0", "2")``);
    dp x ep (the top-2 ``MoE``, ``set_aux_loss_weight(0.01)``, its
    ``dropped_fraction``); dp x pp (the heterogeneous LM ``GPipe`` under
    both schedules); dp x sp (causal ring attention). Prints the losses
    keyed as JAX keys them and returns them. Under a launcher
    (``torchrun``: ``WORLD_SIZE`` set) this process is one rank; else it
    spawns ``n_devices`` ranks itself, as JAX builds its own n-device CPU
    mesh: gloo on the CPU without a card, NCCL when every rank has a card
    of its own, gloo on shared cards otherwise (``backend`` overrides)."""
    import os

    import torch
    if backend is None:
        if not torch.cuda.is_available():
            backend = "cpu"
        elif n_devices <= torch.cuda.device_count():
            backend = "nccl"
        else:
            backend = "gloo"
    if os.environ.get("WORLD_SIZE"):
        from bigdl_tpu_torch.utils.engine import Engine
        Engine.init(backend=backend)
        out = _legs_main(n_devices, backend)
        rank = Engine.rank()
    else:
        out = spawn(_legs_main, n_devices, (n_devices, backend),
                    backend=backend)[0]
        rank = 0
    if rank == 0:
        print(f"dryrun_multichip({n_devices}): OK — dp, dp x tp (Megatron "
              f"MLP), dp x ep (MoE), dp x pp (hetero GPipe), dp x sp (ring "
              f"attention); losses={out['losses']}; backend={backend}, "
              f"step={out['step_modes']}", flush=True)
    return out


if __name__ == "__main__":
    import sys
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
