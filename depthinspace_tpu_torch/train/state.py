"""Training state, port of ``depthinspace_tpu/train/state.py``.

The JAX ``TrainState`` is one pytree (step, params, optax state, PRNG key)
threaded through the jitted step. Here it holds the objects the eager step
updates in place: the step count, the model, a ``torch.optim.Adam`` with
optax.adam's defaults (the same update: bias-corrected moments, eps
outside the square root) and ``rng``, the JAX state's threefry key
(``utils/jrandom.py``): ``key(seed)``, the init's key, as the JAX worker
sets it; each train step splits it into the next key and the step's keys
as the JAX step does. The key lives on the host as two words.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..utils import jrandom


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    rng: jrandom.Key

    @classmethod
    def create(cls, model: torch.nn.Module, learning_rate: float = 1e-4,
               seed: int = 42, device=None) -> "TrainState":
        """Moves ``model`` to ``device`` (None: the card, see
        ``device.resolve_device``); ``rng = jrandom.key(seed)``."""
        dev = resolve_device(device)
        model.to(dev)
        optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        return cls(step=0, model=model, optimizer=optimizer,
                   rng=jrandom.key(seed))
