"""The trainer's tensorboard event writer and reader, with no dependency
on the `tensorboard` or `protobuf` packages.

`SummaryWriter(logdir, max_queue=...)` writes the standard event file
`events.out.tfevents.<secs>.<host>.<pid>.<uid>` that
`torch.utils.tensorboard.SummaryWriter` writes, for the calls the
trainer makes: `add_scalar(tag, value, step)` (a `Summary.Value` with a
`simple_value`), `add_text(tag, text, step)` (a `DT_STRING` tensor under
the tag `<tag>/text_summary` with the `text` plugin's metadata),
`flush()` and `close()`. The file is a sequence of TFRecords (little
endian u64 length, masked CRC32C of the length bytes, the payload, masked
CRC32C of the payload), each payload one `Event` protobuf, the first one
carrying `file_version "brain.Event:2"`. The protobuf messages are
encoded here by hand: wall_time (1, double), step (2, int64),
file_version (3, string) and summary (5) of `Event`; value (1) of
`Summary`; tag (1), simple_value (2, float), tensor (8) and metadata (9)
of `Summary.Value`.

Events are queued in memory and written when `max_queue` of them wait,
at `flush()` and at `close()`; no thread is started.

`read_events(path)` decodes such a file back into dicts, checking both
CRCs of every record, so a run can hold what it wrote without the
`tensorboard` package.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import List, Optional

__all__ = ["SummaryWriter", "read_events", "crc32c", "masked_crc32c"]

FILE_VERSION = "brain.Event:2"
_DT_STRING = 7

# -- CRC32C (Castagnoli), table driven ---------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)
del _i, _c


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord mask of the CRC32C of `data`."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _record(payload: bytes) -> bytes:
    head = struct.pack("<Q", len(payload))
    return (head + struct.pack("<I", masked_crc32c(head)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


# -- protobuf encoding --------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64 values take ten bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(wall_time: float, step: int = 0, file_version: str = None,
           value: bytes = None) -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if value is not None:
        out += _bytes_field(5, _bytes_field(1, value))  # Summary.value
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    return (_bytes_field(1, tag.encode()) + _key(2, 5)
            + struct.pack("<f", float(value)))


def _text_value(tag: str, text: str) -> bytes:
    # TensorProto: dtype DT_STRING, shape [1], string_val [text]
    shape = _bytes_field(2, _key(1, 0) + _varint(1))
    tensor = (_key(1, 0) + _varint(_DT_STRING) + _bytes_field(2, shape)
              + _bytes_field(8, text.encode("utf-8")))
    # SummaryMetadata.plugin_data: plugin_name "text", content
    # TextPluginData(version=0), whose encoding is empty
    metadata = _bytes_field(1, _bytes_field(1, b"text") + _bytes_field(2, b""))
    return (_bytes_field(1, f"{tag}/text_summary".encode())
            + _bytes_field(8, tensor) + _bytes_field(9, metadata))


# -- the writer --------------------------------------------------------------

_uid = itertools.count()


class SummaryWriter:
    """Scalars and text into one event file under `logdir` (module doc)."""

    def __init__(self, logdir: str, max_queue: int = 10,
                 filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.max_queue = max(int(max_queue), 1)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time()):010d}."
            f"{socket.gethostname()}.{os.getpid()}.{next(_uid)}"
            f"{filename_suffix}")
        self._queue: List[bytes] = []
        self._file = open(self.path, "wb")
        self._file.write(_record(_event(time.time(),
                                        file_version=FILE_VERSION)))
        self._file.flush()

    def _add(self, payload: bytes) -> None:
        self._queue.append(_record(payload))
        if len(self._queue) >= self.max_queue:
            self.flush()

    def add_scalar(self, tag: str, value, step: int = 0,
                   walltime: Optional[float] = None) -> None:
        self._add(_event(walltime or time.time(), int(step),
                         value=_scalar_value(tag, float(value))))

    def add_text(self, tag: str, text: str, step: int = 0,
                 walltime: Optional[float] = None) -> None:
        self._add(_event(walltime or time.time(), int(step),
                         value=_text_value(tag, str(text))))

    def flush(self) -> None:
        if self._file is None:
            return
        self._file.write(b"".join(self._queue))
        self._queue.clear()
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self.flush()
            self._file.close()
            self._file = None


# -- the reader --------------------------------------------------------------


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message:
    an int for varints, bytes for length-delimited fields and fixed
    widths."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 2:
            size, i = _read_varint(buf, i)
            v, i = buf[i:i + size], i + size
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, v


def _read_varint(buf: bytes, i: int):
    shift = out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _decode_value(buf: bytes) -> dict:
    out = {}
    for field, _, v in _fields(buf):
        if field == 1:
            out["tag"] = v.decode()
        elif field == 2:
            out["simple_value"] = struct.unpack("<f", v)[0]
        elif field == 8:
            for f2, _, v2 in _fields(v):
                if f2 == 8:
                    out.setdefault("text", []).append(v2.decode("utf-8"))
                elif f2 == 1:
                    out["dtype"] = v2
        elif field == 9:
            for f2, _, v2 in _fields(v):
                if f2 == 1:
                    out["plugin_name"] = next(
                        (x.decode() for f3, _, x in _fields(v2) if f3 == 1),
                        None)
    if "text" in out:
        out["text"] = out["text"][0] if len(out["text"]) == 1 \
            else out["text"]
    return out


def read_events(path: str) -> List[dict]:
    """The events of one event file, in order: dicts with `wall_time`,
    `step` and either `file_version` or `values` (each a dict with `tag`
    and `simple_value`, or `text`, `dtype` and `plugin_name`). Raises
    ValueError on a truncated record or a CRC that does not match."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at {i}")
        head = data[i:i + 8]
        (size,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc32c(head):
            raise ValueError(f"{path}: length CRC mismatch at {i}")
        payload = data[i + 12:i + 12 + size]
        if len(payload) != size or i + 16 + size > len(data):
            raise ValueError(f"{path}: truncated record at {i}")
        (crc,) = struct.unpack("<I", data[i + 12 + size:i + 16 + size])
        if crc != masked_crc32c(payload):
            raise ValueError(f"{path}: payload CRC mismatch at {i}")
        i += 16 + size
        ev = {"wall_time": 0.0, "step": 0}
        for field, _, v in _fields(payload):
            if field == 1:
                ev["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                ev["step"] = v - (1 << 64) if v >> 63 else v
            elif field == 3:
                ev["file_version"] = v.decode()
            elif field == 5:
                ev["values"] = [_decode_value(x) for f2, _, x in _fields(v)
                                if f2 == 1]
        events.append(ev)
    return events
