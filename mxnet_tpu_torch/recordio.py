"""RecordIO of the port: ``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``, ``pack`` and ``unpack``, copied from the framework-free
``mxnet_tpu/recordio.py`` L31-217 (reference API: python/mxnet/recordio.py,
src/io/image_recordio.h).

Records are delimited by kMagic (0xced7230a) and a length word whose upper
3 bits carry the continuation flag, the payload padded to 4 bytes;
IRHeader packs (flag, label, id, id2) as ``IfQQ``. The ``.rec`` and
``.idx`` files are the JAX package's byte for byte, in both directions.
``pack_img`` and ``unpack_img`` need an image codec and are not yet
ported (ROADMAP A9).
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference: recordio.py:36)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open and self.handle:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        del d["handle"]
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d.get("is_open", False)
        self.is_open = False
        self.handle = None
        if is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def _write_part(self, cflag, buf):
        lrec = (cflag << 29) | len(buf)
        self.handle.write(struct.pack("<II", _kMagic, lrec))
        self.handle.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def write(self, buf):
        """Write one record, splitting at 4-byte-aligned magic occurrences
        into continuation parts (cflag 1/2/3) like the reference dmlc
        RecordIO, so any payload round-trips byte-exactly."""
        assert self.writable
        if len(buf) >= (1 << 29):
            raise MXNetError("RecordIO record exceeds 2^29 bytes")
        magic = struct.pack("<I", _kMagic)
        dptr = 0
        lower = (len(buf) // 4) * 4
        first = True
        i = 0
        while i < lower:
            if buf[i:i + 4] == magic:
                self._write_part(1 if first else 2, buf[dptr:i])
                first = False
                dptr = i + 4
            i += 4
        self._write_part(0 if first else 3, buf[dptr:])

    def _read_part(self):
        hdr = self.handle.read(8)
        if len(hdr) < 8:
            return None, 0
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _kMagic:
            raise MXNetError("Invalid RecordIO magic number at offset %d"
                             % (self.handle.tell() - 8))
        cflag = (lrec >> 29) & 7
        length = lrec & ((1 << 29) - 1)
        buf = self.handle.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.handle.read(pad)
        return buf, cflag

    def read(self):
        """Read one logical record, stitching continuation parts back
        together (re-inserting the magic consumed at each seam)."""
        assert not self.writable
        buf, cflag = self._read_part()
        if buf is None or cflag == 0:
            return buf
        if cflag != 1:
            raise MXNetError("RecordIO record starts with continuation part")
        magic = struct.pack("<I", _kMagic)
        parts = [buf]
        while cflag != 3:
            part, cflag = self._read_part()
            if part is None or cflag not in (2, 3):
                raise MXNetError("truncated multi-part RecordIO record")
            parts.append(magic)
            parts.append(part)
        return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a .idx sidecar (reference:
    recordio.py:170)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """Pack a header + byte payload (reference: recordio.py:291)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, header.label, header.id, header.id2)
        return hdr + s
    label = _np.asarray(header.label, dtype=_np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """reference: recordio.py unpack."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    raise MXNetError("recordio.pack_img is not yet ported (ROADMAP A9: an "
                     "image codec)")


def unpack_img(s, iscolor=-1, cv_flag=None):
    raise MXNetError("recordio.unpack_img is not yet ported (ROADMAP A9: an "
                     "image codec)")
