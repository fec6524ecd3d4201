"""Fully-connected neural nets evaluated pointwise over grid-shaped inputs.

PyTorch counterpart of ``odil_tpu/nn.py:23-72`` (reference
``src/odil/core.py:779-862``): weights are ``(n_out, n_in)`` matrices,
biases length ``n_out``; evaluation maps a list of equally-shaped input
tensors to a list of equally-shaped outputs by applying the tanh MLP
pointwise.  The random weights (the JAX package's default "lecun"
initializer) come from an explicit ``torch.Generator``; they are not the JAX
package's bits for the same seed (``convert.arrays_from_numpy`` carries a
JAX state across instead).  No model of the port uses the JAX package's
other initializers, activations or input/output maps, so they are not
ported.
"""

import numpy as np
import torch

from .fields import NeuralNet
from .runtime import torch_dtype

__all__ = ["make_neural_net", "eval_neural_net"]

def make_neural_net(layers, dtype, device, generator):
    """A NeuralNet with weights uniform in (-s, s), s = sqrt(3 / n_in),
    drawn from `generator` (a CPU ``torch.Generator``) and zero biases, on
    `device` in `dtype`.

    layers: neuron counts per layer, e.g. [1, 5, 5, 1]."""
    dt = torch_dtype(dtype)
    weights, biases = [], []
    for ni, no in zip(layers[:-1], layers[1:]):
        s = float(np.sqrt(3.0 / ni))
        u = torch.rand((no, ni), generator=generator, dtype=torch.float64)
        weights.append(((2 * u - 1) * s).to(device=device, dtype=dt))
        biases.append(torch.zeros((no,), dtype=dt, device=device))
    return NeuralNet(weights, biases)


def eval_neural_net(net, inputs, frozen=False):
    """Evaluates `net` pointwise over a list of equally-shaped input tensors;
    returns the list of outputs, each of the input shape.  ``frozen=True``
    detaches the weights and biases from autograd."""
    weights, biases = list(net.weights), list(net.biases)
    if len(weights) != len(biases):
        raise ValueError("Weights and biases do not match")
    if weights[0].shape[1] != len(inputs):
        raise ValueError(f"Network expects {weights[0].shape[1]} inputs, got {len(inputs)}")
    if frozen:
        weights = [w.detach() for w in weights]
        biases = [b.detach() for b in biases]
    h = torch.stack(list(inputs), dim=-1)  # (*grid, n_in)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.einsum("...i,oi->...o", h, w) + b
        if i < len(weights) - 1:
            h = torch.tanh(h)
    return [h[..., i] for i in range(h.shape[-1])]
