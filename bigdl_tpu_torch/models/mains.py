"""What the port's training mains share: JAX's ``--distributed`` flag,
the Engine mesh it brings up, the trainer it picks, and the seed JAX's
mains draw their shuffles from."""

from __future__ import annotations

import os


def add_distributed_flag(parser) -> None:
    """JAX's ``--distributed``: train over the Engine mesh with
    ``DistriOptimizer`` (one process a rank, e.g. under ``torchrun``)."""
    parser.add_argument("--distributed", action="store_true",
                        help="data-parallel training over the Engine mesh "
                             "(DistriOptimizer); run one process a rank")


def seed_as_jax(always: bool = False) -> None:
    """What JAX's mains do first: ``Engine.init()``, which seeds
    ``RandomGenerator`` from ``BIGDL_SEED`` (default 1). Most of JAX's mains
    call it only when the Engine is not initialised yet; the NCF, text
    classifier, TreeLSTM and Wide & Deep mains call it always
    (``always=True``). Call it before ``distributed_setup``, which
    initialises the Engine itself."""
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    if Engine.is_initialized() and not always:
        return
    seed = int(os.environ.get("BIGDL_SEED", "1"))
    if Engine.is_initialized():
        Engine.config().seed = seed
    else:
        Engine.init(seed=seed)
    RandomGenerator.set_seed(seed)


def distributed_setup(args) -> None:
    """With ``--distributed``: bring up the Engine mesh (gloo on the CPU
    for ``--device cpu``, NCCL on the card otherwise) and point
    ``args.device`` at this rank's device."""
    if not getattr(args, "distributed", False):
        return
    from bigdl_tpu_torch.utils.engine import Engine
    if Engine.mesh_if_up() is None:
        Engine.init(backend="cpu" if args.device == "cpu" else None)
    args.device = str(Engine.device())


def trainer(args):
    """``DistriOptimizer`` under ``--distributed``, else
    ``LocalOptimizer``."""
    if getattr(args, "distributed", False):
        from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
        return DistriOptimizer
    from bigdl_tpu_torch.optim import LocalOptimizer
    return LocalOptimizer
