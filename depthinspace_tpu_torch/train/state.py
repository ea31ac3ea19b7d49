"""Training state, port of ``depthinspace_tpu/train/state.py``.

The JAX ``TrainState`` is one pytree (step, params, optax state, PRNG key)
threaded through the jitted step. Here it holds the objects the eager step
updates in place: the step count, the ``DispNet``, a ``torch.optim.Adam``
with optax.adam's defaults (the same update: bias-corrected moments, eps
outside the square root) and a ``torch.Generator`` on the model's device,
seeded from the run's seed, for the step's random draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return self.generator.device

    @classmethod
    def create(cls, model: torch.nn.Module, learning_rate: float = 1e-4,
               seed: int = 42, device=None) -> "TrainState":
        """Moves ``model`` to ``device`` (None: the card, see
        ``device.resolve_device``)."""
        dev = resolve_device(device)
        model.to(dev)
        optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(step=0, model=model, optimizer=optimizer,
                   generator=generator)
