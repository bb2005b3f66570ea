"""Carry generator weights across from the JAX package.

The JAX generator's parameters, flattened to numpy arrays keyed by flax
path (``Conv_0/kernel``, ``ResidualBlock_3/InstanceNorm_0/scale``,
``Upsample_1/ConvTranspose_0/kernel``...), map onto the port's
``state_dict``:

- a conv kernel ``.../Conv_i/kernel`` (flax HWIO) becomes
  ``....Conv_i.weight`` (torch OIHW);
- the transposed-conv kernel ``.../ConvTranspose_0/kernel`` stays HWIO,
  since the zero-skip kernel and its plain version take it so;
- instance-norm ``scale``/``bias`` and the tail conv's ``bias`` map
  straight across.

All of the JAX package's generator layouts share this one tree. The
``.npz`` that ``translate --weights`` reads is the same flat dict
(``np.savez(path, **params)``).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from cyclegan_tpu_torch.config import GeneratorConfig
from cyclegan_tpu_torch.models.generator import ResNetGenerator


def config_from_flax(params: Mapping[str, np.ndarray]) -> GeneratorConfig:
    """The generator architecture a flat flax parameter dict describes."""
    if "Conv_0/kernel" not in params:
        raise KeyError("not a generator parameter dict: no 'Conv_0/kernel'")

    def count(block: str) -> int:
        found = {int(m.group(1)) for key in params
                 if (m := re.match(rf"{block}_(\d+)/", key))}
        return len(found)

    return GeneratorConfig(
        filters=int(np.shape(params["Conv_0/kernel"])[-1]),
        num_downsampling_blocks=count("Downsample"),
        num_residual_blocks=count("ResidualBlock"),
        num_upsample_blocks=count("Upsample"),
    )


def flax_param_shapes(config: GeneratorConfig, channels: int = 3) -> dict:
    """Flat flax key -> shape of every parameter of the generator."""
    gen = ResNetGenerator(config, channels, channels, device="meta")
    shapes = {}
    for key, value in gen.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith(".weight"):  # a conv kernel, OIHW
            key = key[: -len("weight")] + "kernel"
            shape = (shape[2], shape[3], shape[1], shape[0])
        shapes[key.replace(".", "/")] = shape
    return shapes


def generator_state_from_flax(
        params: Mapping[str, np.ndarray], channels: int = 3
) -> dict[str, torch.Tensor]:
    """The port's generator ``state_dict`` for a flat flax parameter dict.
    Raises on an unknown or missing key and on a shape that does not fit
    the architecture the dict describes."""
    expected = flax_param_shapes(config_from_flax(params), channels)
    unknown = sorted(set(params) - set(expected))
    missing = sorted(set(expected) - set(params))
    if unknown or missing:
        raise KeyError(f"flax parameters do not match the generator: "
                       f"unknown {unknown}, missing {missing}")
    state = {}
    for key, value in params.items():
        value = np.array(value, dtype=np.float32)
        if value.shape != expected[key]:
            raise ValueError(f"{key}: shape {value.shape}, expected "
                             f"{expected[key]}")
        torch_key = key.replace("/", ".")
        if torch_key.endswith(".kernel") and "ConvTranspose_" not in key:
            torch_key = torch_key[: -len("kernel")] + "weight"
            value = value.transpose(3, 2, 0, 1)
        state[torch_key] = torch.from_numpy(np.ascontiguousarray(value))
    return state


def random_flax_params(config: GeneratorConfig, seed: int,
                       channels: int = 3) -> dict[str, np.ndarray]:
    """Generator parameters at the JAX package's init distribution, from a
    numpy seed: N(0, 0.02) for kernels and norm scales, zeros for biases."""
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in flax_param_shapes(config, channels).items():
        if key.endswith("/bias"):
            params[key] = np.zeros(shape, np.float32)
        else:
            params[key] = rng.normal(0.0, 0.02, shape).astype(np.float32)
    return params


def signal_flax_params(config: GeneratorConfig, seed: int,
                       channels: int = 3) -> dict[str, np.ndarray]:
    """Generator parameters that keep activations far from zero, from a
    numpy seed: kernels N(0, 1/fan-in), norm scales N(1, 0.3), biases
    N(0, 0.2). At the init distribution the output is nearly the tail
    conv's bias, so a comparison of two paths through the generator sees
    little; these weights give it a real signal."""
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in flax_param_shapes(config, channels).items():
        if key.endswith("/kernel"):
            # A transposed conv's output pixel sees 4 taps on average.
            fan_in = 4 * shape[2] if "ConvTranspose_" in key else \
                int(np.prod(shape[:-1]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif key.endswith("/scale"):
            v = rng.normal(1.0, 0.3, shape)
        else:
            v = rng.normal(0.0, 0.2, shape)
        params[key] = v.astype(np.float32)
    return params
