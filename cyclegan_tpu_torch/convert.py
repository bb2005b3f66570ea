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

All of the JAX package's resnet-trunk generator layouts share one tree,
and so do its discriminator layouts. Two generator forms have trees of
their own, and the architecture a dict describes is read from its keys
and shapes (``layout_from_flax``):

- the perturb trunk (``trunk_impl="perturb"``): ``ResidualBlock_i``'s two
  convs are 1x1, [1, 1, f, f] in flax, [f, f, 1, 1] here;
- the scanned trunk (``scan_blocks=True``): every trunk leaf stacked on a
  leading axis under ``ScannedTrunk/ResidualBlock_0/...``; a stacked conv
  kernel [B, 3, 3, I, O] becomes [B, O, I, 3, 3] here.
  ``stack_trunk_params`` and ``unstack_trunk_params`` carry a flat dict
  between the two storages (JAX ``generator.py:232-258``).

The ``.npz`` that ``translate --weights`` reads is the generator's flat
dict (``np.savez(path, **params)``).

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


SCANNED = "ScannedTrunk/ResidualBlock_0/"


def _is_conv_kernel(flax_key: str) -> bool:
    return flax_key.endswith("/kernel") and "ConvTranspose_" not in flax_key


def flax_key(torch_key: str) -> str:
    """The flax path of a port ``state_dict`` key."""
    if torch_key.endswith(".weight"):
        torch_key = torch_key[: -len("weight")] + "kernel"
    return torch_key.replace(".", "/")


def to_torch_layout(key: str, value: np.ndarray) -> np.ndarray:
    """A flax value as the port holds it: HWIO conv kernels to OIHW, and a
    stacked [B, H, W, I, O] trunk kernel to [B, O, I, H, W]."""
    if not _is_conv_kernel(key):
        return value
    return value.transpose(0, 4, 3, 1, 2) if np.ndim(value) == 5 else \
        value.transpose(3, 2, 0, 1)


def to_flax_layout(key: str, value: np.ndarray) -> np.ndarray:
    """The inverse of ``to_torch_layout``."""
    if not _is_conv_kernel(key):
        return value
    return value.transpose(0, 3, 4, 2, 1) if np.ndim(value) == 5 else \
        value.transpose(2, 3, 1, 0)


def _count(params: Mapping, block: str) -> int:
    return len({int(m.group(1)) for key in params
                if (m := re.match(rf"{block}_(\d+)/", key))})


def layout_from_flax(params: Mapping[str, np.ndarray]) -> dict:
    """The generator's parameter-tree layout a flat flax dict describes:
    {"trunk_impl": "resnet" or "perturb", "scan_blocks": bool}."""
    scanned = any(k.startswith(SCANNED) for k in params)
    first = params.get("ResidualBlock_0/Conv_0/kernel")
    perturb = first is not None and tuple(np.shape(first)[:2]) == (1, 1)
    return {"trunk_impl": "perturb" if perturb else "resnet",
            "scan_blocks": scanned}


def config_from_flax(params: Mapping[str, np.ndarray]) -> GeneratorConfig:
    """The generator architecture a flat flax parameter dict describes."""
    if "Conv_0/kernel" not in params:
        raise KeyError("not a generator parameter dict: no 'Conv_0/kernel'")
    stacked = params.get(SCANNED + "Conv_0/kernel")
    return GeneratorConfig(
        filters=int(np.shape(params["Conv_0/kernel"])[-1]),
        num_downsampling_blocks=_count(params, "Downsample"),
        num_residual_blocks=(int(np.shape(stacked)[0]) if stacked is not None
                             else _count(params, "ResidualBlock")),
        num_upsample_blocks=_count(params, "Upsample"),
    )


def stack_trunk_params(params: Mapping[str, np.ndarray],
                       num_blocks: int) -> dict:
    """A flat unrolled-trunk dict (``ResidualBlock_0..N-1``) in the
    ``scan_blocks`` storage: each trunk leaf stacked on a leading axis
    under ``ScannedTrunk/ResidualBlock_0`` (JAX ``stack_trunk_params``)."""
    out = {k: v for k, v in params.items()
           if not re.match(r"ResidualBlock_\d+/", k)}
    leaves = sorted(k[len("ResidualBlock_0/"):] for k in params
                    if k.startswith("ResidualBlock_0/"))
    for leaf in leaves:
        out[SCANNED + leaf] = np.stack(
            [np.asarray(params[f"ResidualBlock_{i}/{leaf}"])
             for i in range(num_blocks)])
    return out


def unstack_trunk_params(params: Mapping[str, np.ndarray],
                         num_blocks: int) -> dict:
    """The inverse of ``stack_trunk_params``."""
    stray = sorted(k for k in params if k.startswith("ScannedTrunk/")
                   and not k.startswith(SCANNED))
    if stray:
        raise ValueError(f"unexpected entries under ScannedTrunk: {stray}")
    out = {k: v for k, v in params.items() if not k.startswith(SCANNED)}
    for key, value in params.items():
        if key.startswith(SCANNED):
            for i in range(num_blocks):
                out[f"ResidualBlock_{i}/{key[len(SCANNED):]}"] = \
                    np.asarray(value)[i]
    return out


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
    """Flat flax key -> flax shape of each of ``net``'s parameters (the
    state_dict's shapes through ``to_flax_layout``'s transposes)."""
    shapes = {}
    for key, value in net.state_dict().items():
        fkey = flax_key(key)
        shapes[fkey] = to_flax_layout(
            fkey, np.broadcast_to(np.empty((), np.bool_), value.shape)).shape
    return shapes


def flax_param_shapes(config: GeneratorConfig, channels: int = 3,
                      trunk_impl: str = "resnet",
                      scan_blocks: bool = False) -> dict:
    """Flat flax key -> shape of every parameter of the generator in the
    given trunk and storage."""
    return _param_shapes(ResNetGenerator(
        config, channels, channels, device="meta", trunk_impl=trunk_impl,
        scan_blocks=scan_blocks))


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
        params, flax_param_shapes(config_from_flax(params), channels,
                                  **layout_from_flax(params)),
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
    skeleton = ResNetGenerator(config, channels, channels, device="meta",
                               **layout_from_flax(kernels))
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
                int(np.prod(shape[-4:-1]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif key.endswith("/scale"):
            v = rng.normal(1.0, 0.3, shape)
        else:
            v = rng.normal(0.0, 0.2, shape)
        params[key] = v.astype(np.float32)
    return params


def random_flax_params(config: GeneratorConfig, seed: int,
                       channels: int = 3, **trunk) -> dict[str, np.ndarray]:
    """Generator parameters at the JAX package's init distribution, from a
    numpy seed: N(0, 0.02) for kernels and norm scales, zeros for biases.
    ``trunk``: ``trunk_impl`` and ``scan_blocks``, as ``flax_param_shapes``
    takes them."""
    return _random(flax_param_shapes(config, channels, **trunk), seed)


def random_discriminator_flax_params(config: DiscriminatorConfig, seed: int,
                                     channels: int = 3) -> dict[str, np.ndarray]:
    """Discriminator parameters at the JAX package's init distribution."""
    return _random(discriminator_param_shapes(config, channels), seed)


def signal_flax_params(config: GeneratorConfig, seed: int,
                       channels: int = 3, **trunk) -> dict[str, np.ndarray]:
    """Generator parameters that keep activations far from zero, from a
    numpy seed: kernels N(0, 1/fan-in), norm scales N(1, 0.3), biases
    N(0, 0.2). At the init distribution the output is nearly the tail
    conv's bias, so a comparison of two paths through the generator sees
    little; these weights give it a real signal. ``trunk`` as
    ``random_flax_params`` takes it."""
    return _signal(flax_param_shapes(config, channels, **trunk), seed)


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
