"""The readings behind the bf16 GPipe limits of
``test_torch_distributed_configs.py`` (``BF16_LOSS``, ``BF16_UPDATE``):
the gaps of a sound run and of two controls that the limits must reject.

    JAX_PLATFORMS=cpu python tests/torch_gpipe_readings.py

Prints, for the last loss (relative): the port's bf16 run against JAX's
bf16 run and against the port's fp32 run; the port's fp32 run against
JAX's bf16 run (a stage that never casts); JAX's bf16 run with SGD at
learning rate 0 against JAX's bf16 run (a frozen run). For the
parameters: the worst leaf's gap between the bf16 and fp32 runs as a
share of the fp32 run's update (a stage that does not update: 1).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import conftest  # noqa: F401 — JAX on the 8-device CPU mesh
    import numpy as np

    import test_torch_distributed_configs as cfg
    import torch_ranks
    from bigdl_tpu_torch import dryrun as tdry
    from test_torch_distributed import _flat_tree, jax_model

    pp_init = _flat_tree(jax_model("pp", 2).get_params())
    pp_samples = tdry.leg_samples("pp", 4)
    spec = {"samples": cfg._samples(),
            "init": _flat_tree(cfg._jax_mlp().get_params()),
            "pp_init": pp_init, "pp_samples": pp_samples}
    got = tdry.spawn(torch_ranks.configs_file, 4, (spec,), backend="cpu",
                     timeout=300)
    bf, fp = got[0]["gpipe/torch.bfloat16"], got[0]["gpipe/torch.float32"]
    jax_bf16 = cfg._jax_gpipe(pp_init, pp_samples)
    jax_frozen = cfg._jax_gpipe(pp_init, pp_samples, lr=0.0)

    def rel(a, b):
        return abs(a - b) / abs(b)

    print(f"loss, port bf16 vs JAX bf16: {rel(bf['loss'], jax_bf16):.3e}")
    print(f"loss, port bf16 vs port fp32: {rel(bf['loss'], fp['loss']):.3e}")
    print(f"loss, port fp32 vs JAX bf16 (never casts): "
          f"{rel(fp['loss'], jax_bf16):.3e}")
    print(f"loss, JAX frozen vs JAX bf16: {rel(jax_frozen, jax_bf16):.3e}")
    share = max(float(np.max(np.abs(bf["params"][k] - a))
                      / np.max(np.abs(a - fp["init"][k])))
                for k, a in fp["params"].items())
    print(f"parameters, worst gap to fp32 as a share of its update: "
          f"{share:.3e}")


if __name__ == "__main__":
    main()
