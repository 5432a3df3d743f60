"""Model-parallel RNG states (counterpart of
paddle_tpu/distributed/meta_parallel/parallel_layers.py, reference
fleet/meta_parallel/parallel_layers/random.py): a tracker of named RNG
states, so that dropout inside a model-parallel region draws from a seed of
its own on each mp rank while the rest of the randomness stays the same on
every rank.

Each named state is an explicit ``torch.Generator`` (one a device, made at
its first draw there from the state's seed). ``rng_state(name)`` makes it
the draw source of the port's dropout (``ops/nn_functional.py``'s
``dropout`` and attention dropout) inside the block, in preference to the
generator a caller passes. ``model_parallel_random_seed(seed)`` seeds
torch's global generator with ``seed`` (the same on every rank) and the
tracker's ``model_parallel_rng`` with ``seed + 1024`` plus the mp rank, so
mp-region masks differ between mp ranks and agree across data replicas.
The masks differ from the JAX package's threefry bits by design (ROADMAP.md,
"Sampling decision").
"""
from __future__ import annotations

import contextlib
import random as _pyrandom

import torch

from ...ops import nn_functional as F
from ..mesh import get_hybrid_communicate_group

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _mp_rank():
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_rank() if hcg is not None else 0


class _NamedState:
    """A seed and its generators, one a device."""

    def __init__(self, seed):
        self.seed = int(seed)
        self._gens = {}

    def generator(self, device):
        device = torch.device(device)
        key = (device.type, device.index)
        gen = self._gens.get(key)
        if gen is None:
            gen = self._gens[key] = torch.Generator(device=device).manual_seed(self.seed)
        return gen


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def add(self, name, seed):
        self.states_[name] = _NamedState(seed)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        """Dropout inside the block draws from state ``name`` (added on
        first use from torch's initial seed + 1024 + the mp rank)."""
        if name not in self.states_:
            self.add(name, torch.initial_seed() + 1024 + _mp_rank())
        with F.draw_source(self.states_[name]):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    seed = seed or _pyrandom.Random().randint(0, 2 ** 31)
    _tracker.reset()
    torch.manual_seed(seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + _mp_rank())
