"""Minimal MJPEG-in-AVI writer for decode tests and the smoke run: no ffmpeg
command line is needed to make a video file.

Emits the simplest RIFF AVI structure libavformat accepts: hdrl(avih,
strl(strh,strf)) + movi('00dc' JPEG chunks) + idx1.
"""

from __future__ import annotations

import io
import struct


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\x00" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(fourcc: bytes, data: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + data)


def write_mjpeg_avi(path: str, frames, fps: int = 8) -> None:
    """frames: list of PIL Images (same size); each is saved as a JPEG."""
    w, h = frames[0].size
    jpegs = []
    for f in frames:
        buf = io.BytesIO()
        f.save(buf, format="JPEG", quality=95)
        jpegs.append(buf.getvalue())

    max_bytes = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I", int(1e6 / fps), max_bytes * fps, 0, 0x10, len(jpegs), 0, 1,
        max_bytes, w, h, 0, 0, 0, 0,
    )
    strh = (b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, len(jpegs),
                          max_bytes, 0, 0)
            + struct.pack("<4H", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))

    movi_entries = b""
    idx_entries = b""
    offset = 4  # after the 'movi' fourcc
    for j in jpegs:
        chunk = _chunk(b"00dc", j)
        idx_entries += b"00dc" + struct.pack("<III", 0x10, offset, len(j))
        offset += len(chunk)
        movi_entries += chunk
    movi = _list(b"movi", movi_entries)
    idx1 = _chunk(b"idx1", idx_entries)

    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
