"""TensorBoard logging with split train and test writers: the port's copy of
the JAX package's ``utils/summary.py``. Train events go to ``output_dir``,
test events to ``output_dir/test``, so TensorBoard overlays them.

The port writes the event files itself, needing neither ``tensorboardX``
nor ``tensorboard``: each file is a TFRecord stream (a little-endian
uint64 length, its masked CRC-32C, the record, the record's masked
CRC-32C) of ``Event`` protobufs encoded by hand. Only what the training
loop logs is encoded: ``simple_value`` scalars and PNG ``image`` values
(PNGs from ``utils/png.py``, with zlib). The JAX package renders each cycle
row as a matplotlib figure with titles; here each [input, translated,
cycled] row is one PNG of the three side by side, without titles.
"""

from __future__ import annotations

import itertools
import os
import re
import socket
import struct
import threading
import time

import numpy as np

from cyclegan_tpu_torch.utils.png import encode_png


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc, table = 0xFFFFFFFF, _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord frame around ``data``."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


# Protobuf wire format, for the few fields of tensorboard's event.proto and
# summary.proto that are written: Event {double wall_time = 1; int64 step =
# 2; string file_version = 3; Summary summary = 5}, Summary {repeated Value
# value = 1}, Value {string tag = 1; float simple_value = 2; Image image =
# 4}, Image {int32 height = 1; int32 width = 2; int32 colorspace = 3; bytes
# encoded_image_string = 4}.

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _field(number, 2, _varint(len(payload)) + payload)


def _event(step: int, *, file_version: str = None, value: bytes = None) -> bytes:
    msg = (_field(1, 1, struct.pack("<d", time.time()))
           + _field(2, 0, _varint(int(step))))
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if value is not None:
        msg += _bytes_field(5, _bytes_field(1, value))
    return msg


_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(tag: str) -> str:
    """The tag as the JAX package's event files hold it: tensorboardX puts
    "_" for each character other than a letter, a digit, "_", "-", "/" or
    ".", and strips leading slashes, so "error/MAE(X, F(G(X)))" is stored
    as "error/MAE_X__F_G_X___"."""
    return _INVALID_TAG_CHARACTERS.sub("_", tag).lstrip("/")


def scalar_value(tag: str, value: float) -> bytes:
    return (_bytes_field(1, clean_tag(tag).encode())
            + _field(2, 5, struct.pack("<f", value)))


def image_value(tag: str, image: np.ndarray) -> bytes:
    """A Summary.Value holding ``image`` (uint8 [H, W, 3]) as a PNG."""
    h, w = image.shape[:2]
    img = (_field(1, 0, _varint(h)) + _field(2, 0, _varint(w))
           + _field(3, 0, _varint(3)) + _bytes_field(4, encode_png(image)))
    return _bytes_field(1, clean_tag(tag).encode()) + _bytes_field(4, img)


_FILE_IDS = itertools.count()


class EventFileWriter:
    """One event file in ``logdir``, appended to under a lock."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_FILE_IDS)}")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab")
        self._lock = threading.Lock()
        self.write(_event(0, file_version="brain.Event:2"))

    def write(self, event: bytes) -> None:
        with self._lock:
            self._file.write(tfrecord(event))

    def flush(self) -> None:
        with self._lock:
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            self._file.close()


class Summary:
    """Two event writers: index 0 = train (output_dir), 1 = test
    (output_dir/test)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self._writers = [EventFileWriter(output_dir),
                         EventFileWriter(os.path.join(output_dir, "test"))]

    def _writer(self, training: bool) -> EventFileWriter:
        return self._writers[0 if training else 1]

    def scalar(self, tag: str, value, step: int, training: bool = True) -> None:
        self._writer(training).write(
            _event(step, value=scalar_value(tag, float(value))))

    def image(self, tag: str, image: np.ndarray, step: int,
              training: bool = True) -> None:
        """image: uint8 [H, W, 3], or [N, H, W, 3] as tags ``tag/i``."""
        if image.ndim == 4:
            for i, im in enumerate(image):
                self.image(f"{tag}/{i}", im, step, training)
            return
        self._writer(training).write(_event(step, value=image_value(tag, image)))

    def image_cycle(self, tag: str, images: np.ndarray, step: int = 0,
                    training: bool = False) -> None:
        """images: uint8 [n, 3, H, W, 3], each row [input, translated,
        cycled], written side by side as one image ``tag/i``."""
        for i, row in enumerate(images):
            self.image(f"{tag}/{i}", np.concatenate(list(row), axis=1), step,
                       training)

    def flush(self) -> None:
        for w in self._writers:
            w.flush()

    def close(self) -> None:
        for w in self._writers:
            w.close()


def _read_varint(buf: bytes, pos: int):
    shift = value = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def _fields(buf: bytes):
    """(number, value) of each field of one protobuf message: ints for
    varints, bytes for the fixed and length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + size], pos + size
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        else:
            raise ValueError(f"unexpected protobuf wire type {wire}")
        yield number, value


def read_records(path: str):
    """The records of one TFRecord file, each frame's CRCs checked."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,), (crc,) = (struct.unpack("<Q", header),
                             struct.unpack("<I", data[pos + 8:pos + 12]))
        record = data[pos + 12:pos + 12 + length]
        (rec_crc,) = struct.unpack("<I", data[pos + 12 + length:
                                              pos + 16 + length])
        if crc != masked_crc32c(header) or rec_crc != masked_crc32c(record):
            raise ValueError(f"{path}: corrupt record at byte {pos}")
        yield record
        pos += 16 + length


def read_scalars(logdir: str) -> dict:
    """tag -> [(step, value), ...] of the ``simple_value`` scalars in the
    event files directly in ``logdir``, in file-name and then write
    order."""
    out: dict = {}
    names = sorted(n for n in os.listdir(logdir) if "tfevents" in n)
    for name in names:
        for record in read_records(os.path.join(logdir, name)):
            event = dict(_fields(record))
            if 5 not in event:
                continue
            for number, value in _fields(event[5]):
                fields = dict(_fields(value))
                if number == 1 and 2 in fields:
                    out.setdefault(fields[1].decode(), []).append(
                        (event.get(2, 0), struct.unpack("<f", fields[2])[0]))
    return out
