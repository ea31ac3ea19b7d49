"""The port's zstd decoder (native/zstd_decode.cpp through utils/zstd.py)
against frames that the ``zstandard`` package writes: byte for byte at
levels -5, 1, 3 and 19, with and without a checksum and a content size, on
empty, 1-byte, text, zero, random float32 and 4 MiB inputs; streamed frames
(no content size), concatenated and skippable frames; a hypothesis
property; truncated and bit-flipped frames raise with a byte offset; a
frame that names a dictionary raises; CRC-32C against its check value."""
import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from depthinspace_tpu_torch.utils import zstd

_RNG = np.random.default_rng(0)
INPUTS = {
    "empty": b"",
    "1 byte": b"x",
    "text": b"".join(b"%d: the quick brown fox jumps over the lazy dog %d\n"
                     % (i, i * i) for i in range(2000)),
    "zeros": bytes(300_000),
    "f32": _RNG.standard_normal(200_000).astype(np.float32).tobytes(),
    "4 MiB": _RNG.integers(0, 6, 4 << 20, dtype=np.uint8).tobytes(),
}


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("checksum,content_size", [(False, False),
                                                   (True, True),
                                                   (True, False),
                                                   (False, True)])
def test_decodes_zstandard_frames_byte_for_byte(level, checksum,
                                                content_size):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    for name, data in INPUTS.items():
        if level == 19 and name == "4 MiB":
            continue                       # level 19 takes seconds here
        out = zstd.decompress(c.compress(data))
        assert out.dtype == np.uint8 and out.tobytes() == data, name


def test_streamed_concatenated_and_skippable_frames():
    text, f32 = INPUTS["text"], INPUTS["f32"]
    cobj = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = cobj.compress(text) + cobj.flush()
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"12345"
    framed = zstandard.ZstdCompressor(level=1, write_checksum=True)
    data = (streamed + skippable + framed.compress(f32)
            + framed.compress(b""))
    assert zstd.decompress(memoryview(data)).tobytes() == text + f32
    assert zstd.decompress(bytearray(streamed)).tobytes() == text


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=5000), level=st.integers(-3, 9),
       repeat=st.integers(1, 40))
def test_decodes_whatever_zstandard_encodes(data, level, repeat):
    payload = data * repeat
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(payload)
    assert zstd.decompress(frame).tobytes() == payload


def test_corrupt_input_raises_with_the_byte_offset():
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        INPUTS["text"])
    for cut in (3, 10, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError, match=r"at byte \d+"):
            zstd.decompress(frame[:cut])
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0x10
    with pytest.raises(zstd.ZstdError, match=r"at byte \d+"):
        zstd.decompress(bytes(flipped))
    with pytest.raises(zstd.ZstdError, match=r"bad magic\) at byte 0"):
        zstd.decompress(b"not zstd")


def test_a_dictionary_frame_raises():
    samples = [b"record %d: value=%d;" % (i, i * 7) for i in range(200)]
    d = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[5])
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        zstd.decompress(frame)


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
