"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the
decision is taken inside the test, never at import). On the card the
kernels build from the repo's sources at first use. This file imports no
JAX: the reference on the card is each kernel's plain PyTorch version.
Tolerance 1e-4 abs on normalised outputs (f32 FMAs and reductions in
another order than the plain version).

  python -m pytest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.convert import generator_state_from_flax, random_flax_params
from cyclegan_tpu_torch.config import GeneratorConfig, ModelConfig
from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    instance_norm_act_pad_cuda,
    instance_norm_act_pad_plain,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    instance_norm_cuda,
    instance_norm_plain,
)
from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
    upsample_norm_relu_pad_cuda,
    upsample_norm_relu_pad_plain,
)
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _arrays(device, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * 2 + 0.5).astype(np.float32)
                             ).to(device) for s in shapes]


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= ATOL


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 9, 7, 40), (3, 64, 64, 8)])
def test_instance_norm_kernel(card, shape):
    x, s, b = _arrays(card, 0, shape, shape[-1:], shape[-1:])
    got = instance_norm_cuda(x, s, b)
    torch.cuda.synchronize()
    _close(got, instance_norm_plain(x, s, b))


@pytest.mark.parametrize("shape,pad,slope", [
    ((2, 16, 16, 64), 1, 0.0), ((1, 9, 7, 40), 3, 0.0), ((2, 8, 8, 96), 0, 0.2)])
def test_epilogue_kernel(card, shape, pad, slope):
    x, s, b = _arrays(card, 1, shape, shape[-1:], shape[-1:])
    got = instance_norm_act_pad_cuda(x, s, b, pad, slope)
    torch.cuda.synchronize()
    _close(got, instance_norm_act_pad_plain(x, s, b, pad, slope))


@pytest.mark.parametrize("shape,cout,pad", [
    ((2, 8, 8, 64), 32, 0), ((1, 7, 5, 24), 40, 3), ((1, 16, 16, 128), 64, 3)])
def test_upsample_kernel(card, shape, cout, pad):
    x, k, s, b = _arrays(card, 2, shape, (3, 3, shape[-1], cout), (cout,), (cout,))
    got = upsample_norm_relu_pad_cuda(x, k, s, b, pad)
    torch.cuda.synchronize()
    _close(got, upsample_norm_relu_pad_plain(x, k, s, b, pad))


def test_kernels_reject_bf16_and_strided_inputs(card):
    x, s, b = _arrays(card, 3, (1, 8, 8, 16), (16,), (16,))
    with pytest.raises(TypeError, match="float32"):
        instance_norm_cuda(x.to(torch.bfloat16), s, b)
    with pytest.raises(ValueError, match="contiguous"):
        instance_norm_cuda(x.transpose(1, 2), s, b)


def test_engine_runs_every_site_on_its_kernel(card):
    cfg = GeneratorConfig(filters=16, num_residual_blocks=3)
    state = generator_state_from_flax(random_flax_params(cfg, 0))
    engine = InferenceEngine(ModelConfig(generator=cfg, image_size=64), state,
                             serve_cfg=ServeConfig(batch_buckets=(2,), sizes=(64,)))
    x = np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    reset_launches()
    (fake,), n_valid = engine.run(x)
    torch.cuda.synchronize()
    assert LAUNCHES == {"instance_norm": 3 + 3, "epilogue": 3, "upsample": 2}
    cpu = InferenceEngine(ModelConfig(generator=cfg, image_size=64), state,
                          serve_cfg=ServeConfig(batch_buckets=(2,), sizes=(64,)),
                          device="cpu")
    (want,), _ = cpu.run(x)
    assert n_valid == 1
    assert (fake.cpu() - want).abs().max().item() <= ATOL
