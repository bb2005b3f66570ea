"""Carry weights and training state across from the JAX package.

The JAX networks' parameters, flattened to numpy arrays keyed by flax
path (``Conv_0/kernel``, ``ResidualBlock_3/InstanceNorm_0/scale``,
``Upsample_1/ConvTranspose_0/kernel``, ``Downsample_2/Conv_0/kernel``...),
map onto the port's ``state_dict``s:

- a conv kernel ``.../Conv_i/kernel`` (flax HWIO) becomes
  ``....Conv_i.weight`` (torch OIHW);
- the transposed-conv kernel ``.../ConvTranspose_0/kernel`` stays HWIO,
  since the zero-skip kernel and its plain version take it so;
- instance-norm ``scale``/``bias`` and the conv biases map straight
  across.

All of the JAX package's generator layouts share one tree, and so do its
discriminator layouts. The ``.npz`` that ``translate --weights`` reads is
the generator's flat dict (``np.savez(path, **params)``).

``state_from_flax`` carries a whole JAX ``CycleGANState`` across, given as
numpy in the form ``state_to_flax`` returns::

  {"step": int,
   "g_params": flat dict, "f_params": ..., "dx_params": ..., "dy_params": ...,
   "g_opt": {"count": int, "mu": flat dict, "nu": flat dict}, "f_opt": ...,
   "dx_opt": ..., "dy_opt": ...}

with each optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) as the
matching ``torch.optim.Adam`` state (``step``, ``exp_avg``,
``exp_avg_sq``); ``mu`` and ``nu`` take their parameters' layouts.

The quantized generator tree of the JAX package's serving tiers
(``serve/engine.py:quantize_params_int8``), flattened the same way, maps
one to one onto the port's quantized state
(``models/quant.py:quantize_state_int8``): ``.../kernel/int8_q`` and
``.../kernel/int8_scale`` of a conv become ``....weight.int8_q`` and
``....weight.int8_scale`` in OIHW, so the per-output-channel scale
[1, 1, 1, O] becomes [O, 1, 1, 1]; those of the transposed conv become
``....ConvTranspose_0.kernel.int8_q``/``.int8_scale`` in HWIO, as they
are; the 1-D leaves map as above.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from cyclegan_tpu_torch.config import Config, DiscriminatorConfig, GeneratorConfig
from cyclegan_tpu_torch.models import PatchGANDiscriminator, ResNetGenerator
from cyclegan_tpu_torch.models.quant import QUANT_KEYS, quantize_state_int8
from cyclegan_tpu_torch.train.state import CycleGANState, create_state

NETWORKS = ("g", "f", "dx", "dy")


def _is_conv_kernel(flax_key: str) -> bool:
    return flax_key.endswith("/kernel") and "ConvTranspose_" not in flax_key


def flax_key(torch_key: str) -> str:
    """The flax path of a port ``state_dict`` key."""
    if torch_key.endswith(".weight"):
        torch_key = torch_key[: -len("weight")] + "kernel"
    return torch_key.replace(".", "/")


def to_torch_layout(key: str, value: np.ndarray) -> np.ndarray:
    """A flax value as the port holds it: HWIO conv kernels to OIHW."""
    return value.transpose(3, 2, 0, 1) if _is_conv_kernel(key) else value


def to_flax_layout(key: str, value: np.ndarray) -> np.ndarray:
    """The inverse of ``to_torch_layout``."""
    return value.transpose(2, 3, 1, 0) if _is_conv_kernel(key) else value


def _count(params: Mapping, block: str) -> int:
    return len({int(m.group(1)) for key in params
                if (m := re.match(rf"{block}_(\d+)/", key))})


def config_from_flax(params: Mapping[str, np.ndarray]) -> GeneratorConfig:
    """The generator architecture a flat flax parameter dict describes."""
    if "Conv_0/kernel" not in params:
        raise KeyError("not a generator parameter dict: no 'Conv_0/kernel'")
    return GeneratorConfig(
        filters=int(np.shape(params["Conv_0/kernel"])[-1]),
        num_downsampling_blocks=_count(params, "Downsample"),
        num_residual_blocks=_count(params, "ResidualBlock"),
        num_upsample_blocks=_count(params, "Upsample"),
    )


def discriminator_config_from_flax(
        params: Mapping[str, np.ndarray]) -> DiscriminatorConfig:
    """The discriminator architecture a flat flax parameter dict
    describes."""
    if "Conv_0/kernel" not in params:
        raise KeyError("not a discriminator parameter dict: no "
                       "'Conv_0/kernel'")
    return DiscriminatorConfig(
        filters=int(np.shape(params["Conv_0/kernel"])[-1]),
        num_downsampling=_count(params, "Downsample"))


def _param_shapes(net: torch.nn.Module) -> dict:
    shapes = {}
    for key, value in net.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith(".weight"):  # a conv kernel, OIHW
            shape = (shape[2], shape[3], shape[1], shape[0])
        shapes[flax_key(key)] = shape
    return shapes


def flax_param_shapes(config: GeneratorConfig, channels: int = 3) -> dict:
    """Flat flax key -> shape of every parameter of the generator."""
    return _param_shapes(ResNetGenerator(config, channels, channels,
                                         device="meta"))


def discriminator_param_shapes(config: DiscriminatorConfig,
                               channels: int = 3) -> dict:
    """Flat flax key -> shape of every parameter of the discriminator."""
    return _param_shapes(PatchGANDiscriminator(config, channels, device="meta"))


def _state_from_flax(params: Mapping[str, np.ndarray], expected: dict,
                     what: str) -> dict[str, torch.Tensor]:
    unknown = sorted(set(params) - set(expected))
    missing = sorted(set(expected) - set(params))
    if unknown or missing:
        raise KeyError(f"flax parameters do not match the {what}: "
                       f"unknown {unknown}, missing {missing}")
    state = {}
    for key, value in params.items():
        value = np.array(value, dtype=np.float32)
        if value.shape != expected[key]:
            raise ValueError(f"{key}: shape {value.shape}, expected "
                             f"{expected[key]}")
        state[flax_key_to_torch(key)] = torch.from_numpy(
            np.ascontiguousarray(to_torch_layout(key, value)))
    return state


def generator_state_from_flax(
        params: Mapping[str, np.ndarray], channels: int = 3
) -> dict[str, torch.Tensor]:
    """The port's generator ``state_dict`` for a flat flax parameter dict.
    Raises on an unknown or missing key and on a shape that does not fit
    the architecture the dict describes."""
    return _state_from_flax(
        params, flax_param_shapes(config_from_flax(params), channels),
        "generator")


def discriminator_state_from_flax(
        params: Mapping[str, np.ndarray], channels: int = 3
) -> dict[str, torch.Tensor]:
    """The port's discriminator ``state_dict`` for a flat flax parameter
    dict; raises as ``generator_state_from_flax`` does."""
    return _state_from_flax(
        params, discriminator_param_shapes(
            discriminator_config_from_flax(params), channels),
        "discriminator")


def _quant_split(key: str, sep: str) -> tuple[str, str]:
    """(the kernel's key, "int8_q" or "int8_scale") for a quantized leaf's
    key, (key, "") for any other."""
    base, _, leaf = key.rpartition(sep)
    return (base, leaf) if leaf in QUANT_KEYS else (key, "")


def quantized_state_from_flax(
        params: Mapping[str, np.ndarray], channels: int = 3
) -> dict[str, torch.Tensor]:
    """The port's quantized generator state for a flat JAX quantized tree
    (module docstring). Raises on an unknown or missing key and on a shape
    or dtype that does not fit the architecture the tree describes."""
    kernels = {_quant_split(k, "/")[0]: v for k, v in params.items()
               if not k.endswith("/int8_scale")}
    config = config_from_flax(kernels)
    skeleton = ResNetGenerator(config, channels, channels, device="meta")
    expected = quantize_state_int8(skeleton.state_dict())
    state = {}
    for key, value in params.items():
        base, leaf = _quant_split(key, "/")
        torch_key = flax_key_to_torch(base) + (f".{leaf}" if leaf else "")
        if torch_key not in expected:
            raise KeyError(f"flax parameter {key} is not in the generator's "
                           "quantized state")
        want = expected[torch_key]
        value = torch.from_numpy(np.ascontiguousarray(
            to_torch_layout(base, np.array(value))))
        if value.shape != want.shape or value.dtype != want.dtype:
            raise ValueError(f"{key}: {value.dtype} {tuple(value.shape)}, "
                             f"expected {want.dtype} {tuple(want.shape)}")
        state[torch_key] = value
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"flax quantized tree lacks {missing}")
    return state


def flax_from_quantized_state(qstate: Mapping[str, torch.Tensor]) -> dict:
    """A port quantized state as a flat flax quantized tree of numpy
    arrays: the inverse of ``quantized_state_from_flax``."""
    out = {}
    for key, value in qstate.items():
        base, leaf = _quant_split(key, ".")
        fkey = flax_key(base)
        out[fkey + (f"/{leaf}" if leaf else "")] = np.ascontiguousarray(
            to_flax_layout(fkey, value.detach().cpu().numpy()))
    return out


def flax_key_to_torch(key: str) -> str:
    """The port ``state_dict`` key of a flax path: the inverse of
    ``flax_key``."""
    torch_key = key.replace("/", ".")
    if _is_conv_kernel(key):
        torch_key = torch_key[: -len("kernel")] + "weight"
    return torch_key


def flax_from_state_dict(state: Mapping[str, torch.Tensor]) -> dict:
    """A port ``state_dict`` (or a dict of its gradients) as a flat flax
    dict of numpy arrays: the inverse of ``*_state_from_flax``."""
    return {flax_key(k): np.ascontiguousarray(
        to_flax_layout(flax_key(k), v.detach().cpu().numpy()))
        for k, v in state.items()}


def _random(shapes: dict, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in shapes.items():
        if key.endswith("/bias"):
            params[key] = np.zeros(shape, np.float32)
        else:
            params[key] = rng.normal(0.0, 0.02, shape).astype(np.float32)
    return params


def _signal(shapes: dict, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params = {}
    for key, shape in shapes.items():
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


def random_flax_params(config: GeneratorConfig, seed: int,
                       channels: int = 3) -> dict[str, np.ndarray]:
    """Generator parameters at the JAX package's init distribution, from a
    numpy seed: N(0, 0.02) for kernels and norm scales, zeros for biases."""
    return _random(flax_param_shapes(config, channels), seed)


def random_discriminator_flax_params(config: DiscriminatorConfig, seed: int,
                                     channels: int = 3) -> dict[str, np.ndarray]:
    """Discriminator parameters at the JAX package's init distribution."""
    return _random(discriminator_param_shapes(config, channels), seed)


def signal_flax_params(config: GeneratorConfig, seed: int,
                       channels: int = 3) -> dict[str, np.ndarray]:
    """Generator parameters that keep activations far from zero, from a
    numpy seed: kernels N(0, 1/fan-in), norm scales N(1, 0.3), biases
    N(0, 0.2). At the init distribution the output is nearly the tail
    conv's bias, so a comparison of two paths through the generator sees
    little; these weights give it a real signal."""
    return _signal(flax_param_shapes(config, channels), seed)


def signal_discriminator_flax_params(config: DiscriminatorConfig, seed: int,
                                     channels: int = 3) -> dict[str, np.ndarray]:
    """Discriminator parameters from the same distribution as
    ``signal_flax_params``: at the init distribution the discriminator
    outputs about 0 whatever its input, so only such weights exercise the
    adversarial gradient."""
    return _signal(discriminator_param_shapes(config, channels), seed)


def state_from_flax(flax_state: Mapping, config: Config,
                    device="cuda") -> CycleGANState:
    """The port's ``CycleGANState`` for a JAX ``CycleGANState`` given as
    numpy (module docstring): the four networks' weights and the four
    Adams' moments and step counts (on the parameters' device, where the
    port's Adam keeps its count). Raises when the parameters do not fit
    the architectures of ``config``."""
    state = create_state(config, 0, device)
    state.step = int(flax_state["step"])
    for name, net, opt in zip(NETWORKS, state.networks, state.optimizers):
        to_state_dict = (discriminator_state_from_flax
                         if isinstance(net, PatchGANDiscriminator)
                         else generator_state_from_flax)
        channels = config.model.channels
        net.load_state_dict(to_state_dict(flax_state[f"{name}_params"], channels))
        adam = flax_state[f"{name}_opt"]
        mu = to_state_dict(adam["mu"], channels)
        nu = to_state_dict(adam["nu"], channels)
        for key, p in net.named_parameters():
            opt.state[p] = {
                "step": torch.tensor(float(adam["count"]), dtype=torch.float32,
                                     device=p.device),
                "exp_avg": torch.empty_like(p).copy_(mu[key]),
                "exp_avg_sq": torch.empty_like(p).copy_(nu[key]),
            }
    return state


def state_to_flax(state: CycleGANState) -> dict:
    """The port's ``CycleGANState`` as numpy in the JAX form that
    ``state_from_flax`` reads; an Adam that has not stepped has count 0 and
    zero moments, as optax's initial state."""
    out = {"step": int(state.step)}
    for name, net, opt in zip(NETWORKS, state.networks, state.optimizers):
        params = dict(net.named_parameters())
        out[f"{name}_params"] = flax_from_state_dict(params)
        moments = {"exp_avg": {}, "exp_avg_sq": {}}
        count = 0
        for key, p in params.items():
            adam = opt.state.get(p, {})
            count = int(adam["step"]) if adam else 0
            for m in moments:
                moments[m][key] = adam[m] if adam else torch.zeros_like(p)
        out[f"{name}_opt"] = {"count": count,
                              "mu": flax_from_state_dict(moments["exp_avg"]),
                              "nu": flax_from_state_dict(moments["exp_avg_sq"])}
    return out
