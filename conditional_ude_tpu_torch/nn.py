"""Tiny MLP on flat parameter vectors (counterpart of ``conditional_ude_tpu/nn.py``).

The fitting engine treats a network's parameters as one flat vector, so
candidate networks are a leading batch axis (``params[R, P]``).  The layout
is the JAX package's: per layer the weight matrix row-major ``[fan_out][fan_in]``,
then the bias.  A JAX parameter vector therefore loads unchanged.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) + log1p(exp(-|x|))``, as ``jax.nn.softplus`` computes it.

    ``torch.nn.functional.softplus`` returns ``x`` itself above its threshold
    of 20, which breaks parity with the JAX head.
    """
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "softplus": softplus,
    "identity": lambda x: x,
}


class MLP(nn.Module):
    """A dense feed-forward network whose parameters are passed in flat.

    ``widths`` are the hidden widths; the output layer is appended with
    ``output_activation`` (softplus by default: the positive production
    head).  The module holds the architecture only, no parameters.
    """

    def __init__(self, input_dims: int, widths: Sequence[int],
                 activations: Sequence[str], output_dims: int = 1,
                 output_activation: str = "softplus"):
        super().__init__()
        if len(widths) == 0:
            raise ValueError("widths must be non-empty")
        if len(widths) != len(activations):
            raise ValueError(
                "number of widths must match number of activation functions")
        for a in (*activations, output_activation):
            if a not in ACTIVATIONS:
                raise ValueError(
                    f"Unknown activation {a!r}; known: {sorted(ACTIVATIONS)}")
        self.input_dims = input_dims
        self.widths = tuple(widths)
        self.activations = tuple(activations)
        self.output_dims = output_dims
        self.output_activation = output_activation

    @property
    def layer_dims(self) -> tuple[tuple[int, int], ...]:
        """(fan_in, fan_out) per dense layer, output layer included."""
        dims = []
        fan_in = self.input_dims
        for w in self.widths:
            dims.append((fan_in, w))
            fan_in = w
        dims.append((fan_in, self.output_dims))
        return tuple(dims)

    @property
    def num_params(self) -> int:
        return sum(fi * fo + fo for fi, fo in self.layer_dims)

    def unflatten(self, flat: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Split ``flat[..., P]`` into per-layer ``(W[..., fo, fi], b[..., fo])`` views."""
        if flat.shape[-1] != self.num_params:
            raise ValueError(
                f"expected {self.num_params} parameters, got {flat.shape[-1]}")
        layers = []
        i = 0
        for fi, fo in self.layer_dims:
            w = flat[..., i:i + fi * fo].unflatten(-1, (fo, fi))
            i += fi * fo
            layers.append((w, flat[..., i:i + fo]))
            i += fo
        return layers

    def forward(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``flat[..., P]`` and ``x[..., input_dims]`` broadcast over their
        batch dims; returns ``[..., output_dims]``."""
        acts = [ACTIVATIONS[a] for a in self.activations] + [
            ACTIVATIONS[self.output_activation]]
        h = x
        for (w, b), act in zip(self.unflatten(flat), acts):
            h = act((w * h.unsqueeze(-2)).sum(-1) + b)
        return h

    def apply(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The JAX package's name for :meth:`forward`."""
        return self(flat, x)

    def scalar(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Scalar output: the trailing output dim squeezed."""
        return self(flat, x)[..., 0]


def chain(width: int | Sequence[int], depth: int | None = None,
          activation: str = "tanh", *, input_dims: int = 2,
          output_dims: int = 1, output_activation: str = "softplus") -> MLP:
    """``chain(4, 2, "tanh")``: two hidden tanh layers of width 4 and a
    softplus scalar head, as in the JAX package."""
    if isinstance(width, int):
        if depth is None:
            raise ValueError("depth required when width is an int")
        widths = (width,) * depth
    else:
        widths = tuple(width)
    return MLP(input_dims, widths, (activation,) * len(widths),
               output_dims=output_dims, output_activation=output_activation)
