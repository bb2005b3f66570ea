"""The port's TensorBoard event files (utils/summary.py), read back with
tensorboard's own event reader, against the JAX package's Summary
(tensorboardX) for the same calls; and the port's PNG images and cycle
panels decoded against the arrays written."""

import io
import os

import numpy as np
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from cyclegan_tpu.utils.summary import Summary as JaxSummary
from cyclegan_tpu_torch.utils import summary as port_summary
from cyclegan_tpu_torch.utils.summary import Summary

CALLS = [("loss_G/total", 1.5, 0, True), ("loss_G/total", 0.25, 1, True),
         ("error/MAE(X, F(G(X)))", 0.125, 0, False), ("elapse", 3.0e5, 7, True),
         ("perf/mfu", 1.2345678e-4, 2, True), ("loss_X/loss", -0.75, 1, False)]


def _scalars(logdir):
    ea = EventAccumulator(logdir, size_guidance={"scalars": 0, "images": 0})
    ea.Reload()
    return {tag: [(e.step, e.value) for e in ea.Scalars(tag)]
            for tag in ea.Tags()["scalars"]}


def _images(logdir):
    ea = EventAccumulator(logdir, size_guidance={"scalars": 0, "images": 0})
    ea.Reload()
    return {tag: [(e.step, e.width, e.height,
                   np.asarray(Image.open(io.BytesIO(e.encoded_image_string))))
                  for e in ea.Images(tag)]
            for tag in ea.Tags()["images"]}


def test_scalars_read_back_as_the_jax_summarys(tmp_path):
    ours, theirs = Summary(str(tmp_path / "port")), JaxSummary(str(tmp_path / "jax"))
    for tag, value, step, training in CALLS:
        ours.scalar(tag, value, step=step, training=training)
        theirs.scalar(tag, value, step=step, training=training)
    ours.close()
    theirs.close()
    for sub in ("", "test"):
        got = _scalars(str(tmp_path / "port" / sub))
        want = _scalars(str(tmp_path / "jax" / sub))
        assert got == want and got
        assert port_summary.read_scalars(str(tmp_path / "port" / sub)) == got
    assert _scalars(str(tmp_path / "port"))["loss_G/total"] == [(0, 1.5), (1, 0.25)]
    assert "error/MAE_X__F_G_X___" in _scalars(str(tmp_path / "port" / "test"))


def test_images_decode_to_the_arrays_written(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (2, 6, 5, 3), dtype=np.uint8)
    rows = rng.integers(0, 256, (2, 3, 8, 8, 3), dtype=np.uint8)
    s = Summary(str(tmp_path))
    s.image("sample", image, step=4)
    s.image("batch", batch, step=5, training=False)
    s.image_cycle("X_cycle", rows, step=9)
    s.close()
    train, test = _images(str(tmp_path)), _images(str(tmp_path / "test"))
    (step, w, h, got), = train["sample"]
    assert (step, w, h) == (4, 20, 12)
    np.testing.assert_array_equal(got, image)
    for i in range(2):
        (step, _, _, got), = test[f"batch/{i}"]
        assert step == 5
        np.testing.assert_array_equal(got, batch[i])
        (step, w, h, got), = test[f"X_cycle/{i}"]
        assert (step, w, h) == (9, 24, 8)
        np.testing.assert_array_equal(got, np.concatenate(list(rows[i]), axis=1))


def test_tfrecord_framing_and_crc32c(tmp_path):
    assert port_summary.crc32c(b"123456789") == 0xE3069283
    frame = port_summary.tfrecord(b"abc")
    assert len(frame) == 8 + 4 + 3 + 4
    path = tmp_path / "events.out.tfevents.0"
    path.write_bytes(frame + port_summary.tfrecord(b""))
    assert list(port_summary.read_records(str(path))) == [b"abc", b""]
    path.write_bytes(frame[:-1] + bytes([frame[-1] ^ 1]))
    try:
        list(port_summary.read_records(str(path)))
    except ValueError as e:
        assert "corrupt" in str(e)
    else:
        raise AssertionError("a corrupt frame was read")
    assert os.path.getsize(path) == len(frame)
