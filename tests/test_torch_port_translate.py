"""The port's translate CLI on a machine without PIL, and from the port's
own checkpoints, on the CPU.

``.npy`` inputs are read with numpy and the PNGs written with zlib
(utils/png.py), so ``translate.main`` runs with PIL blocked in
``sys.modules``. The PNGs, decoded with PIL once it is unblocked, are
``to_uint8`` of the engine's output for the same images, exactly: the same
plain versions on the CPU, in the same flushes.
"""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import translate
from cyclegan_tpu_torch.convert import (
    flax_from_state_dict,
    generator_state_from_flax,
    random_flax_params,
)
from cyclegan_tpu_torch.data.augment import preprocess_test
from cyclegan_tpu_torch.data.sources import SyntheticSource
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer
from cyclegan_tpu_torch.utils.plotting import to_uint8
from cyclegan_tpu_torch.utils.png import encode_png

GEN = pc.GeneratorConfig(filters=4, num_downsampling_blocks=1,
                         num_residual_blocks=1, num_upsample_blocks=1)
SIZE = 32


def _inputs(root, n=3):
    src = SyntheticSource(n, n, image_size=40)
    os.makedirs(root)
    for i in range(n):
        np.save(os.path.join(root, f"img{i}.npy"), src.load("testA", i))
    return [preprocess_test(src.load("testA", i), SIZE) for i in range(n)]


def _expected(g_params, f_params, images, **layout):
    engine = InferenceEngine(
        pc.ModelConfig(generator=GEN, image_size=SIZE, **layout),
        generator_state_from_flax(g_params),
        generator_state_from_flax(f_params),
        serve_cfg=ServeConfig(batch_buckets=(1, 8), sizes=(SIZE,),
                              with_cycle=True),
        device="cpu")
    return translate.translate_arrays(engine, np.stack(images))


def _decode(path):
    with open(path, "rb") as f:
        return np.asarray(Image.open(io.BytesIO(f.read())))


def _check_outputs(out, images, fake, cycled):
    names = sorted(os.listdir(out))
    assert names == sorted([f"img{i}.png" for i in range(3)]
                           + [f"img{i}_panel.png" for i in range(3)])
    for i, image in enumerate(images):
        np.testing.assert_array_equal(_decode(os.path.join(out, f"img{i}.png")),
                                      to_uint8(fake[i]))
        panel = np.concatenate([image, fake[i], cycled[i]], axis=1)
        np.testing.assert_array_equal(
            _decode(os.path.join(out, f"img{i}_panel.png")), to_uint8(panel))


def test_translate_runs_without_pil_on_npy_inputs(tmp_path, monkeypatch):
    images = _inputs(str(tmp_path / "in"))
    g, f = random_flax_params(GEN, 1), random_flax_params(GEN, 2)
    for name, params in (("G", g), ("F", f)):
        np.savez(str(tmp_path / f"{name}.npz"), **params)
    out = str(tmp_path / "out")
    monkeypatch.setitem(sys.modules, "PIL", None)
    translate.main(["--weights", str(tmp_path / "G.npz"), str(tmp_path / "F.npz"),
                    "--input", str(tmp_path / "in"), "--output", out,
                    "--image_size", str(SIZE), "--panels", "--device", "cpu"])
    monkeypatch.undo()
    _check_outputs(out, images, *_expected(g, f, images))


def test_translate_reads_the_ports_checkpoint_ring(tmp_path, monkeypatch, capsys):
    config = pc.Config(model=pc.ModelConfig(generator=GEN, image_size=SIZE,
                                            **pc.KERNEL_LAYOUT))
    state = create_state(config, 3, device="cpu")
    ckpt = Checkpointer(str(tmp_path / "run"), keep=2)
    ckpt.save(create_state(config, 4, device="cpu"), 0, meta=config.model_meta())
    ckpt.save(state, 1, meta=config.model_meta())
    images = _inputs(str(tmp_path / "in"))
    out = str(tmp_path / "out")
    monkeypatch.setitem(sys.modules, "PIL", None)
    translate.main(["--output_dir", str(tmp_path / "run"), "--input",
                    str(tmp_path / "in"), "--output", out, "--panels",
                    "--device", "cpu"])
    monkeypatch.undo()
    assert "translated 3 images" in capsys.readouterr().out
    g = flax_from_state_dict(state.g.state_dict())
    f = flax_from_state_dict(state.f.state_dict())
    _check_outputs(out, images, *_expected(g, f, images, **pc.KERNEL_LAYOUT))


def test_translate_without_a_checkpoint_exits(tmp_path):
    _inputs(str(tmp_path / "in"))
    with pytest.raises(SystemExit, match="no checkpoint"):
        translate.main(["--output_dir", str(tmp_path / "empty"), "--input",
                        str(tmp_path / "in"), "--output", str(tmp_path / "o"),
                        "--device", "cpu"])


def test_encode_png_decodes_with_pil():
    img = np.random.default_rng(0).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(encode_png(img)))), img)
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img.astype(np.float32))


def test_translate_defaults_to_the_ring_under_runs(tmp_path, monkeypatch,
                                                   capsys):
    """With neither --weights nor --seed, translate reads the ring under
    --output_dir, "runs" by default, as the JAX package's does; with no
    ring there it ends the run and makes no directory, and random weights
    need an explicit --seed."""
    images = _inputs(str(tmp_path / "in"))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no checkpoint under runs/checkpoints"):
        translate.main(["--input", "in", "--output", "out", "--device", "cpu"])
    assert not os.path.exists("runs") and not os.path.exists("out")

    config = pc.Config(model=pc.ModelConfig(generator=GEN, image_size=SIZE))
    state = create_state(config, 6, device="cpu")
    Checkpointer("runs", keep=1).save(state, 0, meta=config.model_meta())
    translate.main(["--input", "in", "--output", "out", "--panels",
                    "--device", "cpu"])
    g = flax_from_state_dict(state.g.state_dict())
    f = flax_from_state_dict(state.f.state_dict())
    _check_outputs("out", images, *_expected(g, f, images))

    # An explicit --seed draws random weights, ring or not.
    translate.main(["--seed", "2", "--input", "in", "--output", "seeded",
                    "--image_size", str(SIZE), "--device", "cpu"])
    assert "translated 3 images -> seeded" in capsys.readouterr().out


def test_mfu_peak_is_keyed_on_the_full_device_name():
    from cyclegan_tpu.utils.flops import train_step_flops_per_pair as jax_flops
    from cyclegan_tpu import config as jc
    from cyclegan_tpu_torch.utils import flops

    assert flops.peak_tflops_for_device_name("NVIDIA H100 80GB HBM3") == 67.0
    assert flops.peak_tflops_for_device_name("NVIDIA H100 PCIe") == 51.0
    for other in ("NVIDIA H100 NVL", "NVIDIA H200", "NVIDIA A100-SXM4-80GB",
                  "H100", ""):
        assert flops.peak_tflops_for_device_name(other) is None, other
    assert flops.peak_tflops_for_device("cpu") is None
    # FusedProp's step costs 18g + 14d, as the JAX package counts it.
    for impl in ("combined", "fusedprop"):
        ours = pc.Config(train=pc.TrainConfig(grad_impl=impl))
        theirs = jc.Config(model=jc.ModelConfig(upsample_impl="zeroskip_fused"),
                           train=jc.TrainConfig(grad_impl=impl))
        assert flops.train_step_flops_per_pair(ours) == jax_flops(theirs), impl
