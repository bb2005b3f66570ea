"""The port's scanned trunk (``scan_blocks=True``) on the CPU.

torch has no ``lax.scan`` to compile, so the port's ``scan_blocks`` is the
JAX package's storage layout: the trunk's parameters stacked on a leading
axis under ``ScannedTrunk.ResidualBlock_0``, the blocks run one by one.
These tests hold that it behaves like the unrolled trunk and like the JAX
package's scanned generator:

- a scanned train step (gradients, then Adam) equals the unrolled one from
  the same weights bitwise, parameters, moments and losses;
- the scanned tree is the JAX package's (keys, shapes), carried across by
  convert.py, ``stack_trunk_params``/``unstack_trunk_params`` are the JAX
  functions' flat counterparts, and the scanned generator and train step
  match the JAX package's scanned ones (forward atol 1e-4; losses rtol
  2e-5 / atol 2e-6, gradients rtol 1e-3 / atol 3e-6), 64², 8 filters, 2
  residual blocks, batch 1, in the kernel layout (Pallas in interpret
  mode);
- a scanned slot restores into a scanned model and round-trips through
  ``unstack_trunk_params``; a resume into the unrolled trunk raises;
  translate reads a scanned ring.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import config as jc
from cyclegan_tpu.models import ResNetGenerator as JaxGenerator
from cyclegan_tpu.models.generator import (
    stack_trunk_params as jax_stack_trunk_params,
)
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import translate
from cyclegan_tpu_torch.convert import (
    NETWORKS,
    config_from_flax,
    flax_from_state_dict,
    generator_state_from_flax,
    layout_from_flax,
    signal_flax_params,
    stack_trunk_params,
    unstack_trunk_params,
)
from cyclegan_tpu_torch.models import ResNetGenerator
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import make_train_step
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

SIZE = 64
GEN = dict(filters=8, num_residual_blocks=2)
BLOCKS = GEN["num_residual_blocks"]
FORWARD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the CPU is shared with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}


def _config(scan, **layout):
    return pc.Config(
        model=pc.ModelConfig(generator=pc.GeneratorConfig(**GEN),
                             discriminator=pc.DiscriminatorConfig(filters=8),
                             image_size=SIZE, scan_blocks=scan, **layout),
        train=pc.TrainConfig(batch_size=1), obs=pc.ObsConfig(health=False))


def _same_weights(scanned, unrolled):
    """Load the scanned state's weights, unstacked, into the unrolled one."""
    for a, b in zip(scanned.networks, unrolled.networks):
        flat = flax_from_state_dict(a.state_dict())
        if isinstance(a, ResNetGenerator):
            flat = unstack_trunk_params(flat, BLOCKS)
            b.load_state_dict(generator_state_from_flax(flat))
        else:
            b.load_state_dict(a.state_dict())


@pytest.mark.parametrize("layout", [{}, pc.KERNEL_LAYOUT],
                         ids=["jax_default", "kernel_layout"])
def test_scanned_step_equals_the_unrolled_step_bitwise(layout):
    scanned = create_state(_config(True, **layout), 0, device="cpu")
    unrolled = create_state(_config(False, **layout), 0, device="cpu")
    # The same seed draws the same initial weights in both storages.
    drawn = unstack_trunk_params(flax_from_state_dict(scanned.g.state_dict()),
                                 BLOCKS)
    for key, value in flax_from_state_dict(unrolled.g.state_dict()).items():
        np.testing.assert_array_equal(drawn[key], value, key)
    _same_weights(scanned, unrolled)
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(
        np.float32)) for _ in range(2))
    w = torch.ones(1)
    for _ in range(2):
        scanned, m_scan = make_train_step(_config(True, **layout), 1)(
            scanned, x, y, w)
        unrolled, m_unrolled = make_train_step(_config(False, **layout), 1)(
            unrolled, x, y, w)
        for key in m_unrolled:
            assert torch.equal(m_scan[key], m_unrolled[key]), key
    for net_s, net_u, opt_s, opt_u in zip(scanned.networks, unrolled.networks,
                                          scanned.optimizers,
                                          unrolled.optimizers):
        params_s = flax_from_state_dict(dict(net_s.named_parameters()))
        params_u = flax_from_state_dict(dict(net_u.named_parameters()))
        if isinstance(net_s, ResNetGenerator):
            params_s = unstack_trunk_params(params_s, BLOCKS)
        assert params_s.keys() == params_u.keys()
        for key in params_u:
            np.testing.assert_array_equal(params_s[key], params_u[key], key)
        for part in ("exp_avg", "exp_avg_sq"):
            moments = {k: opt_s.state[p][part]
                       for k, p in net_s.named_parameters()}
            flat = flax_from_state_dict(moments)
            if isinstance(net_s, ResNetGenerator):
                flat = unstack_trunk_params(flat, BLOCKS)
            want = flax_from_state_dict({k: opt_u.state[p][part] for k, p in
                                         net_u.named_parameters()})
            for key in want:
                np.testing.assert_array_equal(flat[key], want[key], key)


def test_scanned_tree_and_stacking_match_jax():
    jax_gen = JaxGenerator(config=jc.GeneratorConfig(**GEN), scan_blocks=True)
    tree = jax.eval_shape(jax_gen.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    shapes = {k: tuple(v.shape) for k, v in
              traverse_util.flatten_dict(tree["params"], sep="/").items()}
    unrolled = signal_flax_params(pc.GeneratorConfig(**GEN), 7)
    stacked = stack_trunk_params(unrolled, BLOCKS)
    assert {k: v.shape for k, v in stacked.items()} == shapes
    want = _flat(jax_stack_trunk_params(_tree(unrolled), BLOCKS))
    assert stacked.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(stacked[key], want[key])
    assert layout_from_flax(stacked) == {"trunk_impl": "resnet",
                                         "scan_blocks": True}
    assert config_from_flax(stacked) == pc.GeneratorConfig(**GEN)
    back = unstack_trunk_params(stacked, BLOCKS)
    assert back.keys() == unrolled.keys()
    assert all(np.array_equal(back[k], unrolled[k]) for k in unrolled)
    state = generator_state_from_flax(stacked)
    assert tuple(state["ScannedTrunk.ResidualBlock_0.Conv_0.weight"].shape) == (
        BLOCKS, 32, 32, 3, 3)
    with pytest.raises(ValueError, match="unexpected entries"):
        unstack_trunk_params({**stacked, "ScannedTrunk/Extra/kernel": 0}, BLOCKS)


def test_scanned_slices_are_channels_last():
    gen = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu",
                          scan_blocks=True)
    weight = gen.ScannedTrunk.ResidualBlock_0.Conv_1.weight
    assert weight[1].is_contiguous(memory_format=torch.channels_last)
    assert not any(k.startswith("ResidualBlock_") for k in gen.state_dict())
    assert not any("skeleton" in k for k in gen.state_dict())


def test_scanned_generator_matches_jax():
    params = stack_trunk_params(signal_flax_params(pc.GeneratorConfig(**GEN),
                                                   8), BLOCKS)
    x = np.random.default_rng(9).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(
        np.float32)
    layout = dict(norm_impl="pallas", pad_impl="epilogue",
                  upsample_impl="zeroskip_fused")
    want = np.asarray(JaxGenerator(config=jc.GeneratorConfig(**GEN),
                                   scan_blocks=True, **layout).apply(
        _tree(params), jnp.asarray(x)))
    gen = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu",
                          scan_blocks=True, **layout)
    gen.load_state_dict(generator_state_from_flax(params))
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    assert 0.05 < np.std(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)


def test_scanned_train_step_matches_jax():
    from tests.test_torch_port_layouts import (
        STEP_GEN,
        _step_configs,
        _step_signal,
        hold_step,
        jax_signal_step,
    )
    jax_cfg, port_cfg = _step_configs(dict(pc.KERNEL_LAYOUT, scan_blocks=True))
    params, x, y = _step_signal()
    params = dict(params, g=stack_trunk_params(params["g"], BLOCKS),
                  f=stack_trunk_params(params["f"], BLOCKS))
    w = np.ones(1, np.float32)
    grads, metrics, numpy_state = jax_signal_step(jax_cfg, params, x, y, w)
    hold_step(port_cfg, grads, metrics, numpy_state, x, y, w)


def test_scanned_slot_restores_and_round_trips(tmp_path, capsys):
    config = _config(True)
    state = create_state(config, 4, device="cpu")
    ckpt = Checkpointer(str(tmp_path / "run"))
    ckpt.save(state, 0, meta=config.model_meta())
    assert ckpt.read_meta()["model"]["scan_blocks"] is True
    restored, epoch = Checkpointer(str(tmp_path / "run")).restore(
        create_state(config, 5, device="cpu"))
    assert epoch == 1
    for a, b in zip(state.networks, restored.networks):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    # The slot's generator file is the flat scanned dict, which unstacks
    # into the unrolled tree the unrolled generator loads.
    saved = torch.load(os.path.join(ckpt.slot, "g.pt"), weights_only=True)
    flat = {k: v.numpy() for k, v in saved.items()}
    assert layout_from_flax(flat)["scan_blocks"]
    unrolled = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu")
    unrolled.load_state_dict(generator_state_from_flax(
        unstack_trunk_params(flat, BLOCKS)))
    x = torch.zeros(1, SIZE, SIZE, 3).uniform_(-1, 1)
    with torch.no_grad():
        assert torch.equal(unrolled(x), restored.g(x))
    # A resume into the unrolled trunk refuses the slot.
    with pytest.raises(ValueError, match="cannot change the trunk"):
        Checkpointer(str(tmp_path / "run")).restore(
            create_state(_config(False), 0, device="cpu"))
    # translate reads the scanned ring with its recorded architecture.
    os.makedirs(tmp_path / "in")
    np.save(tmp_path / "in" / "b.npy",
            np.random.default_rng(1).integers(0, 256, (70, 64, 3), np.uint8))
    g, _, model_cfg = translate.load_checkpoint(str(tmp_path / "run"))
    assert model_cfg.scan_blocks and layout_from_flax(g)["scan_blocks"]
    translate.main(["--output_dir", str(tmp_path / "run"), "--input",
                    str(tmp_path / "in"), "--output", str(tmp_path / "out"),
                    "--device", "cpu"])
    assert "translated 1 images" in capsys.readouterr().out


def test_remat_and_scan_together_match_the_unrolled_trunk():
    scanned = create_state(_config(True, remat=True, **pc.KERNEL_LAYOUT), 0,
                           device="cpu")
    unrolled = create_state(_config(False, **pc.KERNEL_LAYOUT), 0,
                            device="cpu")
    _same_weights(scanned, unrolled)
    x = torch.zeros(1, SIZE, SIZE, 3).uniform_(-1, 1,
                                               generator=torch.Generator().manual_seed(2))
    for net in (scanned.g, unrolled.g):
        net.zero_grad()
        net(x).square().sum().backward()
    grads_s = flax_from_state_dict({k: p.grad for k, p in
                                    scanned.g.named_parameters()})
    grads_u = flax_from_state_dict({k: p.grad for k, p in
                                    unrolled.g.named_parameters()})
    grads_s = unstack_trunk_params(grads_s, BLOCKS)
    for key in grads_u:
        np.testing.assert_array_equal(grads_s[key], grads_u[key], key)
    assert set(NETWORKS) == {"g", "f", "dx", "dy"}
