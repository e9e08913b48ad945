"""Minimal TensorBoard event-file writer (counterpart of the JAX package's
utils/tb_writer.py): pure Python and numpy, no tensorboard package.

It writes the TFRecord/Event wire format directly, scalars and PNG images,
which TensorBoard renders: the Event/Summary protobuf subset is encoded by
hand, with its masked CRC32C.  The records are the JAX writer's byte for
byte, apart from the wall times.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

import numpy as np

# ---------------------------------------------------------------- crc32c ----
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ----------------------------------------------------------- proto encode ----
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


class SummaryWriter:
    """add_scalar / add_image subset of torch.utils.tensorboard's writer."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.segtorch"
        self._fh = open(os.path.join(log_dir, fname), "wb")
        self._write_event(_pb_double(1, time.time()) +
                          _pb_bytes(4, b"brain.Event:2"))  # file_version

    def _write_event(self, event_bytes: bytes):
        data = event_bytes
        header = struct.pack("<Q", len(data))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(data)
        self._fh.write(struct.pack("<I", _masked_crc(data)))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int = 0):
        val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
        summary = _pb_bytes(1, val)
        event = (_pb_double(1, time.time()) + _pb_varint(2, int(step))
                 + _pb_bytes(5, summary))
        self._write_event(event)

    def add_image(self, tag: str, image: np.ndarray, step: int = 0):
        """image: HWC uint8 (or float in [0,1])."""
        from PIL import Image as PILImage
        import io

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        buf = io.BytesIO()
        PILImage.fromarray(arr).save(buf, format="PNG")
        img_pb = (_pb_varint(1, arr.shape[0]) + _pb_varint(2, arr.shape[1])
                  + _pb_varint(3, arr.shape[2] if arr.ndim == 3 else 1)
                  + _pb_bytes(4, buf.getvalue()))
        val = _pb_bytes(1, tag.encode()) + _pb_bytes(4, img_pb)
        summary = _pb_bytes(1, val)
        event = (_pb_double(1, time.time()) + _pb_varint(2, int(step))
                 + _pb_bytes(5, summary))
        self._write_event(event)

    def close(self):
        self._fh.close()
