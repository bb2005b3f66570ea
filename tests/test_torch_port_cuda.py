"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the
decision is taken inside the test, never at import). On the card the
kernels build from the repo's sources at first use. This file imports no
JAX: the reference on the card is each kernel's plain PyTorch version.
Tolerance 1e-4 abs on normalised outputs and on the backward kernels' dx
(f32 FMAs and reductions in another order than the plain version); the
backward kernels' dscale and dbias, sums over H*W, 1e-5 of the sum of
the terms' magnitudes. A reduced train step on the kernels against the
same step on the CPU through the plain versions: the ten loss scalars
rtol 1e-4, every gradient leaf at a relative L2 error of 1e-3. The int8
upsample kernel (K6) against its plain version at 1e-4, and a reduced
engine's int8_fused tier on the card against the same tier on the CPU at
1e-4 on the tanh output. The upsample kernels (K5, K6) also at the
full-width batch-1 shapes and at edge cases of their plan, twice on the
same inputs (bitwise equal), and their split-TF32 pre-norm output against
float64: at most twice the plain f32 version's relative L2 distance. The backward kernels also at the full-width
train step's batch-1 shapes, at edge cases of their launch plan, and twice
on the same inputs, where their outputs must be bitwise equal. The forward
kernels (K1, K3) likewise at their full-width shapes (batch 1, and batch 4
in waves), at edge cases of their plan and of the copy width, twice on the
same inputs (bitwise equal), and their mean and inv against float64: at
most twice the plain f32 version's relative L2 distance.

  python -m pytest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.config import (
    Config,
    DiscriminatorConfig,
    GeneratorConfig,
    ModelConfig,
)
from cyclegan_tpu_torch.convert import (
    discriminator_state_from_flax,
    generator_state_from_flax,
    random_flax_params,
    signal_discriminator_flax_params,
    signal_flax_params,
)
from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    instance_norm_act_pad_backward_cuda,
    instance_norm_act_pad_backward_plain,
    instance_norm_act_pad_cuda,
    instance_norm_act_pad_plain,
    reflect_pad_transpose,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    instance_norm_backward_cuda,
    instance_norm_backward_plain,
    instance_norm_cuda,
    instance_norm_plain,
)
from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
    conv_transpose_zeroskip,
    upsample_norm_relu_pad_cuda,
    upsample_norm_relu_pad_int8_cuda,
    upsample_norm_relu_pad_int8_plain,
    upsample_norm_relu_pad_plain,
)
from cyclegan_tpu_torch.models.quant import quantize_state_int8
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import METRIC_KEYS, make_grad_fn

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


def _rel_l2(a, b):
    return ((a.double() - b).norm() / b.norm()).item()


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


def _forward_case(device, seed, shape, pad, slope, offset=0):
    """Inputs of a forward kernel, K1 where slope is None and K3 otherwise:
    (kernel fn, plain fn, args). ``offset`` floats shift x off its 16-byte
    boundary (a contiguous view into a larger buffer): 4-byte copies."""
    x, s, b = _arrays(device, seed, shape, shape[-1:], shape[-1:])
    if offset:
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(shape)
    if slope is None:
        return instance_norm_cuda, instance_norm_plain, (x, s, b)
    return (instance_norm_act_pad_cuda, instance_norm_act_pad_plain,
            (x, s, b, pad, slope))


# K1 (slope None) and K3 on one launch a call: the full-width batch-1
# shapes of the serving forward and the train step; batch-4 shapes whose
# slabs exceed the card's shared memory (waves) and two that fit it; C = 40
# at a storage offset (4-byte copies) and C = 6; [1, 9, 7, 40] pad 3;
# N = 3; inputs off a 16-byte boundary.
FORWARD_CASES = [
    ((1, 256, 256, 64), 0, None, 0), ((1, 128, 128, 128), 0, None, 0),
    ((1, 64, 64, 256), 0, None, 0), ((1, 64, 64, 256), 1, 0.0, 0),
    ((1, 64, 64, 128), 0, 0.2, 0), ((1, 32, 32, 256), 0, 0.2, 0),
    ((1, 32, 32, 512), 0, 0.2, 0),
    ((4, 256, 256, 64), 0, None, 0), ((4, 128, 128, 128), 0, 0.0, 0),
    ((1, 16, 16, 40), 0, None, 1), ((1, 16, 16, 40), 2, 0.2, 1),
    ((1, 12, 10, 6), 2, 0.2, 0), ((1, 9, 7, 40), 3, 0.0, 0),
    ((1, 9, 7, 40), 0, None, 0), ((3, 20, 24, 64), 1, 0.0, 0),
    ((3, 20, 24, 64), 0, None, 0), ((2, 16, 16, 64), 1, 0.2, 3),
    ((2, 16, 16, 64), 0, None, 2), ((4, 64, 64, 256), 1, 0.0, 0),
    ((1, 64, 64, 256), 1, 0.0, 1), ((1, 32, 32, 256), 0, 0.2, 0)]


@pytest.mark.parametrize("shape,pad,slope,offset", FORWARD_CASES)
def test_forward_kernels_at_full_width_and_edge_cases(card, shape, pad, slope,
                                                      offset):
    kernel, plain, args = _forward_case(card, 15, shape, pad, slope, offset)
    got = kernel(*args)
    torch.cuda.synchronize()
    _close(got, plain(*args))


@pytest.mark.parametrize("shape,pad,slope", [
    ((1, 256, 256, 64), 0, None), ((1, 64, 64, 256), 1, 0.0),
    ((4, 128, 128, 128), 0, 0.2), ((1, 12, 10, 6), 2, 0.2),
    ((1, 32, 32, 512), 0, 0.2)])
def test_forward_kernels_are_deterministic(card, shape, pad, slope):
    """Two calls on the same inputs give bitwise-equal y, mean and inv: no
    float atomics, every sum in a fixed order."""
    kernel, _, args = _forward_case(card, 16, shape, pad, slope)
    first = kernel(*args)
    second = kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(1, 256, 256, 64), (1, 64, 64, 256),
                                   (4, 128, 128, 128)])
def test_forward_statistics_as_near_float64_as_plain(card, shape):
    """The kernel's mean and inv are no further from float64 of the same
    input, by relative L2, than twice the plain f32 version's."""
    kernel, plain, args = _forward_case(card, 17, shape, 0, None)
    got, want = kernel(*args)[1:], plain(*args)[1:]
    exact = instance_norm_plain(*[a.double() for a in args])[1:]
    torch.cuda.synchronize()
    for g, w, e in zip(got, want, exact):
        assert _rel_l2(g, e) <= 2 * _rel_l2(w, e)


# The upsample kernels' added cases: the full-width generator's two
# batch-1 blocks; N = 3 with H and W that end inside a patch (8 x 16), so a
# sample's last patches are clipped and none may reach into the next
# sample; an image smaller than one patch; Cin 6 and an odd Cout 9 (4-byte
# copies and scalar stores).
UPSAMPLE_EDGE_CASES = [((1, 64, 64, 256), 128, 0), ((1, 128, 128, 128), 64, 3),
                       ((3, 9, 20, 32), 48, 1), ((1, 3, 5, 16), 24, 1),
                       ((2, 6, 7, 6), 9, 2)]


@pytest.mark.parametrize("shape,cout,pad", [
    ((2, 8, 8, 64), 32, 0), ((1, 7, 5, 24), 40, 3), ((1, 16, 16, 128), 64, 3),
    *UPSAMPLE_EDGE_CASES])
def test_upsample_kernel(card, shape, cout, pad):
    x, k, s, b = _arrays(card, 2, shape, (3, 3, shape[-1], cout), (cout,), (cout,))
    got = upsample_norm_relu_pad_cuda(x, k, s, b, pad)
    torch.cuda.synchronize()
    _close(got, upsample_norm_relu_pad_plain(x, k, s, b, pad))


def _int8_weights(k):
    quant = quantize_state_int8({"up.kernel": k})
    return quant["up.kernel.int8_q"], quant["up.kernel.int8_scale"]


@pytest.mark.parametrize("shape,cout,pad", [
    ((2, 8, 8, 64), 32, 0), ((1, 7, 5, 24), 40, 3), ((1, 16, 16, 128), 64, 3),
    ((1, 4, 4, 8), 160, 1), *UPSAMPLE_EDGE_CASES])
def test_upsample_int8_kernel(card, shape, cout, pad):
    x, k, s, b = _arrays(card, 8, shape, (3, 3, shape[-1], cout), (cout,), (cout,))
    q, kscale = _int8_weights(k)
    got = upsample_norm_relu_pad_int8_cuda(x, q, kscale, s, b, pad)
    torch.cuda.synchronize()
    _close(got, upsample_norm_relu_pad_int8_plain(x, q, kscale, s, b, pad))
    with pytest.raises(TypeError, match="int8"):
        upsample_norm_relu_pad_int8_cuda(x, k, kscale, s, b, pad)


def _upsample_case(device, seed, shape, cout, int8):
    """A K5 or K6 call on seeded inputs: (kernel fn, plain fn, args)."""
    x, k, s, b = _arrays(device, seed, shape, (3, 3, shape[-1], cout), (cout,),
                         (cout,))
    if int8:
        return (upsample_norm_relu_pad_int8_cuda,
                upsample_norm_relu_pad_int8_plain, (x, *_int8_weights(k), s, b))
    return upsample_norm_relu_pad_cuda, upsample_norm_relu_pad_plain, (x, k, s, b)


@pytest.mark.parametrize("int8", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("shape,cout,pad", [((1, 64, 64, 256), 128, 0),
                                            ((3, 9, 20, 32), 48, 1)])
def test_upsample_kernels_are_deterministic(card, int8, shape, cout, pad):
    """Two calls on the same inputs give bitwise-equal y, mean, inv and
    conv_out: no float atomics, every sum in a fixed order."""
    kernel, _, args = _upsample_case(card, 13, shape, cout, int8)
    first = kernel(*args, pad, keep_conv=True)
    second = kernel(*args, pad, keep_conv=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("int8", [False, True], ids=["K5", "K6"])
def test_upsample_conv_out_as_near_float64_as_plain(card, int8):
    """At [1, 64, 64, 256] -> 128 the kernel's pre-norm conv_out (split
    TF32 on the tensor cores) is no further from float64 of the plain
    function, by relative L2, than twice the plain f32 version's own
    distance."""
    kernel, plain, args = _upsample_case(card, 14, (1, 64, 64, 256), 128, int8)
    got = kernel(*args, keep_conv=True)[3]
    want = plain(*args, keep_conv=True)[3]
    x, weights = args[0].double(), args[1].double()
    exact = conv_transpose_zeroskip(x, weights)
    if int8:
        exact = exact * args[2].double().reshape(-1)
    torch.cuda.synchronize()
    assert _rel_l2(got, exact) <= 2 * _rel_l2(want, exact)


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
    assert LAUNCHES == {"instance_norm": 3 + 3, "instance_norm_backward": 0,
                        "epilogue": 3, "epilogue_backward": 0, "upsample": 2,
                        "upsample_int8": 0}
    cpu = InferenceEngine(ModelConfig(generator=cfg, image_size=64), state,
                          serve_cfg=ServeConfig(batch_buckets=(2,), sizes=(64,)),
                          device="cpu")
    (want,), _ = cpu.run(x)
    assert n_valid == 1
    assert (fake.cpu() - want).abs().max().item() <= ATOL


def test_int8_fused_engine_matches_cpu(card):
    cfg = GeneratorConfig(filters=16, num_residual_blocks=3)
    state = generator_state_from_flax(signal_flax_params(cfg, 1))
    engines = [InferenceEngine(
        ModelConfig(generator=cfg, image_size=64), state,
        serve_cfg=ServeConfig(batch_buckets=(1, 2), sizes=(64,),
                              int8_tier=True, infer_tier=True), device=device)
        for device in (card, "cpu")]
    x = np.random.default_rng(9).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    reset_launches()
    (fake,), _ = engines[0].run(x, tier="int8_fused")
    torch.cuda.synchronize()
    assert LAUNCHES == {"instance_norm": 3 + 3, "instance_norm_backward": 0,
                        "epilogue": 3, "epilogue_backward": 0, "upsample": 0,
                        "upsample_int8": 2}
    (want,), _ = engines[1].run(x, tier="int8_fused")
    assert want.std().item() > 0.05
    assert (fake.cpu() - want).abs().max().item() <= ATOL


def _close_backward(got, want, g_norm, xhat):
    """dx at ATOL; dscale and dbias at 1e-5 of sum |g * xhat| and sum |g|."""
    assert got[0].shape == want[0].shape
    assert (got[0] - want[0]).abs().max().item() <= ATOL
    for i, terms in ((1, g_norm * xhat), (2, g_norm)):
        tol = 1e-5 * terms.abs().sum(dim=(1, 2))
        assert got[i].shape == want[i].shape == tol.shape
        assert bool(((got[i] - want[i]).abs() <= tol).all())


def _xhat(x, mean, inv):
    return (x - mean[:, None, None, :]) * inv[:, None, None, :]


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 9, 7, 40),
                                   (1, 64, 64, 64), (2, 8, 8, 256),
                                   (1, 64, 64, 256)])
def test_instance_norm_backward_kernel(card, shape):
    x, s, b, g = _arrays(card, 5, shape, shape[-1:], shape[-1:], shape)
    _, mean, inv = instance_norm_cuda(x, s, b)
    got = instance_norm_backward_cuda(x, s, mean, inv, g)
    torch.cuda.synchronize()
    _close_backward(got, instance_norm_backward_plain(x, s, mean, inv, g), g,
                    _xhat(x, mean, inv))


@pytest.mark.parametrize("shape,pad,slope", [
    ((2, 16, 16, 8), 3, 0.0), ((1, 9, 7, 40), 3, 0.2), ((1, 5, 6, 8), 3, 0.2),
    ((2, 16, 16, 64), 1, 0.0), ((1, 8, 8, 256), 1, 0.2),
    ((2, 12, 12, 40), 0, 0.2), ((1, 16, 16, 256), 0, 0.0),
    ((1, 64, 64, 64), 3, 0.0),
    # The full-width train step's batch-1 shapes.
    ((1, 64, 64, 256), 1, 0.0), ((1, 128, 128, 128), 0, 0.0),
    ((1, 256, 256, 64), 3, 0.0), ((1, 32, 32, 512), 0, 0.2)])
def test_epilogue_backward_kernel(card, shape, pad, slope):
    n, h, w, c = shape
    x, s, b, g = _arrays(card, 6, shape, (c,), (c,),
                         (n, h + 2 * pad, w + 2 * pad, c))
    _, mean, inv = instance_norm_act_pad_cuda(x, s, b, pad, slope)
    got = instance_norm_act_pad_backward_cuda(x, s, b, mean, inv, g, pad, slope)
    torch.cuda.synchronize()
    want = instance_norm_act_pad_backward_plain(x, s, b, mean, inv, g, pad, slope)
    # The folded |g| bounds the cotangent that reaches the norm.
    _close_backward(got, want, reflect_pad_transpose(g.abs(), pad),
                    _xhat(x, mean, inv))


# Reduced train step: generators of 8 filters, 2 down, 2 residual, 2 up;
# discriminators of 8 filters, 3 downsampling; 64², batch 2.
TRAIN_CONFIG = Config(model=ModelConfig(
    generator=GeneratorConfig(filters=8, num_residual_blocks=2),
    discriminator=DiscriminatorConfig(filters=8), image_size=64))


def _signal_state(device):
    state = create_state(TRAIN_CONFIG, 0, device)
    g, d = TRAIN_CONFIG.model.generator, TRAIN_CONFIG.model.discriminator
    for i, net in enumerate(state.networks):
        net.load_state_dict(
            generator_state_from_flax(signal_flax_params(g, 10 + i)) if i < 2
            else discriminator_state_from_flax(
                signal_discriminator_flax_params(d, 10 + i)))
    return state


def test_train_step_runs_every_site_on_its_kernel(card):
    rng = np.random.default_rng(7)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
            for _ in range(2))
    w = torch.ones(2)
    grad_fn = make_grad_fn(TRAIN_CONFIG, 2)
    reset_launches()
    grads, metrics = grad_fn(_signal_state(card), x.to(card), y.to(card),
                             w.to(card))
    torch.cuda.synchronize()
    # 6 generator and 6 discriminator applies per step, each backpropagated:
    # per generator 1 + 2 + 2 norm sites, 2 epilogues, 2 upsamples; per
    # discriminator 3 epilogues; an upsample's backward is an epilogue's.
    assert LAUNCHES == {"instance_norm": 30, "instance_norm_backward": 30,
                        "epilogue": 12 + 18, "epilogue_backward": 24 + 18,
                        "upsample": 12, "upsample_int8": 0}
    want_grads, want = grad_fn(_signal_state("cpu"), x, y, w)
    for k in METRIC_KEYS:
        assert metrics[k].item() == pytest.approx(want[k].item(), rel=1e-4)
    for ours, theirs in zip(grads, want_grads):
        assert ours.keys() == theirs.keys()
        for key, value in theirs.items():
            err = (ours[key].cpu() - value).norm() / value.norm()
            assert err.item() <= 1e-3, key


def _backward_case(device, seed, shape, pad, slope, offset=0):
    """Inputs of a backward kernel with the statistics of the plain forward
    (which takes any C); slope None for K2. ``offset`` floats shift x and g
    off their 16-byte boundary (contiguous views into a larger buffer)."""
    n, h, w, c = shape
    g_shape = (n, h + 2 * pad, w + 2 * pad, c)
    x, s, b, g = _arrays(device, seed, shape, (c,), (c,), g_shape)
    if offset:
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(shape)
        g = torch.cat([g.new_zeros(offset), g.flatten()])[offset:].view(g_shape)
    _, mean, inv = instance_norm_plain(x, s, b)
    if slope is None:
        return (x, s, mean, inv, g), instance_norm_backward_cuda, \
            instance_norm_backward_plain, g
    return (x, s, b, mean, inv, g, pad, slope), \
        instance_norm_act_pad_backward_cuda, \
        instance_norm_act_pad_backward_plain, reflect_pad_transpose(g.abs(), pad)


@pytest.mark.parametrize("shape,pad,slope,offset", [
    ((1, 12, 10, 6), 0, None, 0), ((1, 12, 10, 6), 2, 0.2, 0),
    ((3, 16, 16, 64), 0, None, 0), ((3, 16, 16, 64), 1, 0.0, 0),
    ((1, 5, 6, 8), 0, None, 0), ((1, 5, 6, 8), 3, 0.2, 0),
    ((2, 16, 16, 64), 0, None, 1), ((2, 16, 16, 64), 1, 0.2, 3)])
def test_backward_kernels_edge_cases(card, shape, pad, slope, offset):
    """C = 6 (scalar loads), N = 3, H*W shorter than a cluster's bands (a
    block with no rows), and inputs off a 16-byte boundary (scalar loads);
    K2 where slope is None, K4 otherwise."""
    args, kernel, plain, g_norm = _backward_case(card, 11, shape, pad, slope,
                                                 offset)
    got = kernel(*args)
    torch.cuda.synchronize()
    x, s = args[0], args[1]
    mean, inv = (args[2], args[3]) if slope is None else (args[3], args[4])
    _close_backward(got, plain(*args), g_norm, _xhat(x, mean, inv))


@pytest.mark.parametrize("shape,pad,slope", [
    ((1, 64, 64, 256), 0, None), ((1, 64, 64, 256), 1, 0.0),
    ((1, 256, 256, 64), 3, 0.0), ((1, 12, 10, 6), 2, 0.2)])
def test_backward_kernels_are_deterministic(card, shape, pad, slope):
    """Two calls on the same inputs give bitwise-equal dx, dscale and
    dbias: no atomics, every sum in a fixed order."""
    args, kernel, _, _ = _backward_case(card, 12, shape, pad, slope)
    first = kernel(*args)
    second = kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
