"""Seeded host RNG of the port: the numpy part of the JAX package's
``RandomGenerator``.

Counterpart of ``bigdl_tpu/utils/random_generator.py`` (``set_seed``,
``numpy``, ``state_dict``, ``load_state_dict``). Dataset shuffles draw from
it, so the same seed gives the same epoch orders in both packages. The JAX
keys for traced randomness have no counterpart here; the port's weights are
drawn from an explicit ``torch.Generator`` (``nn/initialization.py``). The
state dict has JAX's keys: the key counter, which nothing here draws
from, is kept as given (0 after ``set_seed``); the salt counter
advances with :meth:`RandomGenerator.next_salt` as JAX's does. So a
checkpoint's RNG state passes between the packages.
"""

from __future__ import annotations

import threading

import numpy as np


class RandomGenerator:
    _lock = threading.Lock()
    _seed: int = 1
    _np: np.random.Generator = np.random.default_rng(1)
    _key_counter: int = 0
    _salt_counter: int = 0

    @classmethod
    def set_seed(cls, seed: int) -> None:
        with cls._lock:
            cls._seed = int(seed)
            cls._np = np.random.default_rng(cls._seed)
            cls._key_counter = cls._salt_counter = 0

    @classmethod
    def get_seed(cls) -> int:
        return cls._seed

    @classmethod
    def next_salt(cls) -> int:
        """JAX's monotonic per-construction salt: 1, 2, ... after
        ``set_seed`` (vision transformers sharing one seed draw
        decorrelated streams)."""
        with cls._lock:
            cls._salt_counter += 1
            return cls._salt_counter

    @classmethod
    def numpy(cls) -> np.random.Generator:
        """The host generator that dataset shuffles draw from."""
        return cls._np

    @classmethod
    def state_dict(cls) -> dict:
        """Seed, numpy bit-generator state and JAX's key/salt counters."""
        with cls._lock:
            return {"seed": cls._seed, "np_state": cls._np.bit_generator.state,
                    "key_counter": cls._key_counter,
                    "salt_counter": cls._salt_counter}

    @classmethod
    def load_state_dict(cls, state: dict) -> None:
        with cls._lock:
            cls._seed = int(state["seed"])
            cls._np = np.random.default_rng(cls._seed)
            cls._np.bit_generator.state = state["np_state"]
            cls._key_counter = int(state.get("key_counter", 0))
            cls._salt_counter = int(state.get("salt_counter", 0))
