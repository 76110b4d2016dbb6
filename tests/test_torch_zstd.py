"""The port's zstd decoder and CRC-32C (``cenet_tpu_torch/native/zstd_decode.cpp``) on the CPU.

The decoder is held to the bytes that went into frames written by the
``zstandard`` package and by the host's ``libzstd`` (through ctypes; the
tests only, the port never loads either): levels −5, 1, 3 and 19, inputs of
about 300 KB (three 128 KiB blocks and a partial one) of random bytes, fp32
weights and runs, with the content checksum and the content size each on and
off, streamed frames that state no size, concatenated and skippable frames,
and tiny and empty ones. Truncated frames and a frame that names a
dictionary raise ``ValueError``; a corrupted block raises (caught by the
structure or by the XXH64 checksum) wherever libzstd refuses it, and never
decodes to other content. CRC-32C is held to the test vectors of RFC 3720
(iSCSI), B.4.
"""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from cenet_tpu_torch.native import crc32c, zstd_decompress

zstandard = pytest.importorskip("zstandard")

# One intra-op thread, as tests/torch_parity.py sets it for the files that import it.
torch.set_num_threads(1)

LEVELS = (-5, 1, 3, 19)
N = 300_000  # past two 128 KiB blocks


def _inputs():
    rng = np.random.default_rng(0)
    runs = np.repeat(rng.integers(0, 4, 6000).astype(np.uint8), rng.integers(1, 120, 6000))[:N]
    return {"random": rng.bytes(N), "fp32": (0.02 * rng.standard_normal(N // 4)).astype(np.float32).tobytes(),
            "runs": runs.tobytes()}


INPUTS = _inputs()


def _decoded(frame, size=None):
    return zstd_decompress(frame, size).tobytes()


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_levels_checksums_and_sizes_match_zstandard(kind):
    data = INPUTS[kind]
    for level in LEVELS:
        for checksum, content_size in ((True, True), (False, False), (True, False)):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=content_size).compress(data)
            assert _decoded(frame) == data, (level, checksum, content_size)
    assert _decoded(frame, size=len(data)) == data


def test_streamed_frames_without_a_size_and_host_libzstd():
    """Frames written a piece at a time state no content size (the decoder
    grows its output); frames from the host's libzstd decode the same."""
    data = INPUTS["fp32"] + INPUTS["runs"]
    c = zstandard.ZstdCompressor(level=3).compressobj()
    frame = b"".join(c.compress(data[i:i + 7000]) for i in range(0, len(data), 7000)) + c.flush()
    assert _decoded(frame) == data
    path = ctypes.util.find_library("zstd")
    if path is None:
        pytest.skip("no host libzstd")
    lib = ctypes.CDLL(path)
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    for level in LEVELS:
        out = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
        n = lib.ZSTD_compress(out, len(out), data, len(data), level)
        assert n < len(out)
        assert _decoded(out.raw[:n]) == data, level


def test_concatenated_and_skippable_frames():
    a, b = INPUTS["runs"][:5000], INPUTS["random"][:70000]
    skip = (0x184D2A53).to_bytes(4, "little") + (11).to_bytes(4, "little") + b"metadata..."
    frames = (zstandard.ZstdCompressor(level=1).compress(a) + skip
              + zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b) + skip)
    assert _decoded(frames) == a + b
    with pytest.raises(ValueError, match="skippable"):
        _decoded(frames[:-3])


def test_tiny_and_empty_frames():
    for data in (b"", b"x", b"ab" * 3, bytes(range(256))):
        for level in (1, 19):
            assert _decoded(zstandard.ZstdCompressor(level=level).compress(data)) == data
    with pytest.raises(ValueError, match="expected"):
        _decoded(zstandard.ZstdCompressor().compress(b"abc"), size=4)


def test_truncated_frames_raise():
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(INPUTS["fp32"][:200_000])
    for cut in (1, 4, 5, 6, 9, 40, len(frame) // 2, len(frame) - 5, len(frame) - 1):
        with pytest.raises(ValueError):
            _decoded(frame[:cut])


@pytest.mark.parametrize("kind", ["fp32", "runs"])
def test_corrupted_blocks_raise(kind):
    """A flipped bit past the frame header never gives other content: the
    decoder raises (the block structure or the content checksum catches it)
    exactly where libzstd raises, and else returns the original bytes (a
    flip in the unused padding bits of a table description changes nothing,
    for libzstd too)."""
    data = INPUTS[kind][:150_000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    rng = np.random.default_rng(1)
    raised = 0
    for _ in range(300):
        bad = bytearray(frame)
        bad[int(rng.integers(6, len(frame)))] ^= 1 << int(rng.integers(0, 8))
        try:
            got = _decoded(bytes(bad))
        except ValueError:
            got = None
        try:
            want = zstandard.ZstdDecompressor().decompress(bytes(bad), max_output_size=1 << 20)
        except zstandard.ZstdError:
            want = None
        assert got == want and got in (None, data)
        raised += got is None
    assert raised > 250


def test_dictionary_frames_and_bad_magic_raise():
    samples = [bytes(f"record {i} of a sample set {i * i}", "ascii") * 4 for i in range(200)]
    d = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[3])
    with pytest.raises(ValueError, match="dictionary"):
        _decoded(frame)
    with pytest.raises(ValueError, match="magic"):
        _decoded(b"\x00" + zstandard.ZstdCompressor().compress(b"abc"))


def test_crc32c_test_vectors():
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43
    assert crc32c(bytes(range(32))) == 0x46DD794E
    assert crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C
    data = INPUTS["random"][:10001]
    assert crc32c(data[4000:], crc32c(data[:4000])) == crc32c(data)  # continued over pieces
