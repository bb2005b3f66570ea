"""The PyTorch port's ops against the JAX package, on the CPU.

Each kernel site of the port (cyclegan_tpu_torch/ops) runs its plain
PyTorch version on a CPU tensor; here that version is held against the
JAX entry of the same function, with the Pallas kernels run in interpret
mode as tests/test_pallas_*.py run them. Inputs come from a numpy seed
and go to both sides. Tolerances: 1e-5 abs for every kernel's function
(f32; only the reduction order differs).

Also: the import guard (the port imports nothing of JAX or of the JAX
package), the wrappers' input checks, and the build module's contract
that importing builds nothing.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops.padding import reflect_pad as jax_reflect_pad
from cyclegan_tpu.ops.pallas import epilogue_kernel as jax_epilogue
from cyclegan_tpu.ops.pallas import norm_kernel as jax_norm
from cyclegan_tpu.ops.pallas import upsample_kernel as jax_upsample
from cyclegan_tpu.ops.upsample import conv_transpose_up2_dense as jax_dense
from cyclegan_tpu.ops.upsample import conv_transpose_zeroskip as jax_zeroskip
from cyclegan_tpu_torch.config import ModelConfig
from cyclegan_tpu_torch.ops import norm, padding, upsample
from cyclegan_tpu_torch.ops.cuda import LAUNCHES, build, norm_kernel
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import instance_norm_act_pad_plain
from cyclegan_tpu_torch.ops.cuda.upsample_kernel import upsample_norm_relu_pad_plain

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    # Conv-output-like activations: a mean well away from 0.
    return [(rng.standard_normal(s) * 2 + 0.5).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 6, 10, 8), (2, 5, 7, 3)])
def test_instance_norm_matches_jax_kernel(shape):
    c = shape[-1]
    x, scale, bias = _arrays(0, shape, (c,), (c,))
    want_y, want_mean, want_inv = jax_norm._forward(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-3, True)
    y, mean, inv = norm_kernel.instance_norm_plain(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0, atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=0, atol=ATOL)
    np.testing.assert_allclose(inv.numpy(), np.asarray(want_inv), rtol=0, atol=ATOL)
    got = norm.instance_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_array_equal(got.numpy(), y.numpy())


@pytest.mark.parametrize("shape,pad,slope", [
    ((2, 8, 8, 16), 1, 0.0),
    ((2, 8, 8, 16), 0, 0.2),
    ((1, 6, 10, 8), 3, 0.0),
    ((2, 5, 7, 8), 3, 0.2),
    ((1, 4, 4, 16), 0, 0.0),
])
def test_instance_norm_act_pad_matches_jax_kernel(shape, pad, slope):
    c = shape[-1]
    x, scale, bias = _arrays(1, shape, (c,), (c,))
    want = jax_epilogue.instance_norm_relu_pad_pallas(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), pad=pad,
        negative_slope=slope, interpret=True, no_vjp=True)
    got = norm.instance_norm_act_pad(_t(x), _t(scale), _t(bias), pad,
                                     negative_slope=slope)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,cout,pad", [
    ((2, 4, 4, 16), 8, 0),
    ((1, 5, 3, 8), 8, 0),
    ((2, 4, 6, 8), 4, 3),
    ((1, 5, 7, 4), 8, 3),
])
def test_upsample_norm_relu_pad_matches_jax_kernel(shape, cout, pad):
    cin = shape[-1]
    x, k, scale, bias = _arrays(2, shape, (3, 3, cin, cout), (cout,), (cout,))
    want = jax_upsample.upsample_norm_relu_pad_pallas(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias),
        pad=pad, interpret=True, no_vjp=True)
    got = upsample.upsample_norm_relu_pad(_t(x), _t(k), _t(scale), _t(bias), pad)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,cout", [((2, 4, 4, 8), 8), ((1, 5, 3, 4), 6),
                                        ((1, 1, 1, 4), 4)])
def test_conv_transpose_forms_match_jax(shape, cout):
    """Raw conv sums of up to ~50 in size: 1e-5 abs plus 1e-6 relative (a
    few f32 ulps of the largest sums)."""
    x, k = _arrays(3, shape, (3, 3, shape[-1], cout))
    zeroskip = upsample.conv_transpose_zeroskip(_t(x), _t(k)).numpy()
    dense = upsample.conv_transpose_up2_dense(_t(x), _t(k)).numpy()
    np.testing.assert_allclose(
        zeroskip, np.asarray(jax_zeroskip(jnp.asarray(x), jnp.asarray(k))),
        rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(
        dense, np.asarray(jax_dense(jnp.asarray(x), jnp.asarray(k))),
        rtol=1e-6, atol=ATOL)
    # Zero-skip against the dense (dilated) form: the same products summed
    # in another order. The JAX package's own zero-skip-vs-dense check
    # misses 1e-5 on the CPU, so this comparison takes 1e-4 abs on these
    # O(10) outputs.
    np.testing.assert_allclose(zeroskip, dense, rtol=0, atol=1e-4)


def test_upsample_plain_matches_dense_reference():
    """The whole upsample block against the dense transposed conv followed
    by the norm tail (1e-4 abs: the dense form sums in another order, and
    the norm scales that difference by inv)."""
    x, k, scale, bias = _arrays(4, (2, 6, 5, 8), (3, 3, 8, 4), (4,), (4,))
    got, _, _ = upsample_norm_relu_pad_plain(_t(x), _t(k), _t(scale), _t(bias), 3)
    dense = upsample.conv_transpose_up2_dense(_t(x), _t(k))
    want, _, _ = instance_norm_act_pad_plain(dense, _t(scale), _t(bias), 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad_matches_jax(pad):
    (x,) = _arrays(5, (2, 5, 7, 3))
    np.testing.assert_array_equal(
        padding.reflect_pad(_t(x), pad).numpy(),
        np.asarray(jax_reflect_pad(jnp.asarray(x), pad)))


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_same_pad_strided_conv_matches_jax(hw):
    x, k = _arrays(6, (2, *hw, 4), (3, 3, 4, 6))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xt = padding.same_pad(padding.to_nchw(_t(x)), 3, 2)
    got = padding.to_nhwc(torch.nn.functional.conv2d(
        xt, _t(k).permute(3, 2, 0, 1), stride=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_plain_versions_do_not_count_launches():
    before = dict(LAUNCHES)
    x, scale, bias = _arrays(7, (1, 4, 4, 8), (8,), (8,))
    norm.instance_norm(_t(x), _t(scale), _t(bias))
    norm.instance_norm_act_pad(_t(x), _t(scale), _t(bias), 1)
    assert LAUNCHES == before


def test_kernel_wrappers_reject_cpu_and_bad_inputs():
    x = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.instance_norm_cuda(x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        norm_kernel.check_activation(x.to(torch.bfloat16), "k")
    with pytest.raises(ValueError, match="reflect pad"):
        norm.instance_norm_act_pad(x, torch.ones(8), torch.zeros(8), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        norm.on_card(torch.zeros(1, device="meta"))


@pytest.mark.parametrize("field,value", [
    ("instance_norm_impl", "xla"), ("pad_impl", "pad"),
    ("upsample_impl", "dense"), ("compute_dtype", "bfloat16"),
])
def test_config_rejects_layouts_not_ported(field, value):
    with pytest.raises(ValueError, match="later slice"):
        ModelConfig(**{field: value})
    with pytest.raises(ValueError, match="unknown"):
        ModelConfig(**{field: "nonsense"})


def test_build_is_lazy_and_reports_missing_nvcc(monkeypatch, tmp_path):
    assert build.library.cache_info().currsize == 0
    assert build.library_path().startswith(build.BUILD_DIR)
    assert {os.path.basename(s) for s in build.sources()} == {
        "epilogue.cu", "instance_norm.cu", "norm_backward.cu", "upsample.cu"}
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "cyclegan_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_the_guard_covers_the_training_modules():
    names = {os.path.relpath(p, REPO) for p in _port_files()}
    for module in ("main", "data/native", "data/pipeline", "data/prefetch",
                   "data/sources", "data/augment", "train/loop",
                   "utils/checkpoint", "utils/summary", "utils/plotting",
                   "utils/flops", "utils/dicts", "utils/png", "translate"):
        assert f"cyclegan_tpu_torch/{module}.py" in names, module


def test_port_imports_nothing_of_jax():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "cyclegan_tpu"}
    files = _port_files()
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned & set(roots), f"{path}:{node.lineno} imports {roots}"
