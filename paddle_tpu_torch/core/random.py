"""Global RNG state (counterpart of paddle_tpu/core/random.py).

One explicit ``torch.Generator`` a device, made at first use from the
global seed; the random creation ops of the namespace draw from the one of
the device they create on. ``seed(s)`` reseeds every generator made so far
(and sets the seed of those made later); ``get_rng_state`` /
``set_rng_state`` round-trip all of them. ``named_generator(name)`` gives
the named streams (model parallelism's 'global_seed' / 'local_seed'), each
seeded from the global seed plus a stable offset of its name.

Draws differ from the JAX package's threefry keys by design (ROADMAP,
"Sampling decision"); the models keep their own seeded generators. The
reference's functional key API (``next_key``, ``trace_key_scope``) has no
counterpart: a traced program here draws from a generator it is given.
"""
from __future__ import annotations

import hashlib

import torch

from ..device import resolve_device

_DEFAULT_SEED = 0
_seed = _DEFAULT_SEED
_gens = {}    # str(device) -> torch.Generator
_named = {}   # (name, str(device)) -> torch.Generator

Generator = torch.Generator


def _key(device) -> str:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _name_offset(name: str) -> int:
    """Stable per-name seed offset: independent of creation order and of
    Python's randomized str hash, so reseeding is reproducible."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little") % 99991 + 1


def generator(device=None) -> torch.Generator:
    """The generator of ``device`` (the current place when None)."""
    key = _key(device)
    gen = _gens.get(key)
    if gen is None:
        gen = _gens[key] = torch.Generator(device=key).manual_seed(_seed)
    return gen


def default_generator() -> torch.Generator:
    return generator(None)


def seed(s: int) -> torch.Generator:
    """paddle.seed: reseeds every device's generator and the named ones;
    returns the current device's."""
    global _seed
    _seed = int(s)
    for gen in _gens.values():
        gen.manual_seed(_seed)
    for (name, _), gen in _named.items():
        gen.manual_seed(_seed + _name_offset(name))
    return default_generator()


def named_generator(name: str, device=None) -> torch.Generator:
    """Named RNG streams, e.g. 'global_seed' vs 'local_seed' for model parallelism."""
    key = (name, _key(device))
    gen = _named.get(key)
    if gen is None:
        gen = _named[key] = torch.Generator(device=key[1]).manual_seed(
            _seed + _name_offset(name))
    return gen


def get_rng_state():
    return {"seed": _seed,
            "default": {k: g.get_state() for k, g in _gens.items()},
            "named": {f"{n}@{d}": g.get_state() for (n, d), g in _named.items()}}


def set_rng_state(state):
    global _seed
    _seed = int(state.get("seed", _seed))
    for key, s in state["default"].items():
        generator(key).set_state(s)
    for key, s in state.get("named", {}).items():
        name, _, dev = key.rpartition("@")
        named_generator(name, dev).set_state(s)
