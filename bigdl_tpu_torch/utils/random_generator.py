"""Seeded host RNG of the port: the numpy part of the JAX package's
``RandomGenerator``.

Counterpart of ``bigdl_tpu/utils/random_generator.py`` (``set_seed``,
``numpy``, ``state_dict``, ``load_state_dict``). Dataset shuffles draw from
it, so the same seed gives the same epoch orders in both packages. The JAX
keys for traced randomness have no counterpart here; the port's weights are
drawn from an explicit ``torch.Generator`` (``nn/initialization.py``).
"""

from __future__ import annotations

import threading

import numpy as np


class RandomGenerator:
    _lock = threading.Lock()
    _seed: int = 1
    _np: np.random.Generator = np.random.default_rng(1)

    @classmethod
    def set_seed(cls, seed: int) -> None:
        with cls._lock:
            cls._seed = int(seed)
            cls._np = np.random.default_rng(cls._seed)

    @classmethod
    def get_seed(cls) -> int:
        return cls._seed

    @classmethod
    def numpy(cls) -> np.random.Generator:
        """The host generator that dataset shuffles draw from."""
        return cls._np

    @classmethod
    def state_dict(cls) -> dict:
        """Seed and numpy bit-generator state."""
        with cls._lock:
            return {"seed": cls._seed, "np_state": cls._np.bit_generator.state}

    @classmethod
    def load_state_dict(cls, state: dict) -> None:
        with cls._lock:
            cls._seed = int(state["seed"])
            cls._np = np.random.default_rng(cls._seed)
            cls._np.bit_generator.state = state["np_state"]
