"""The port's zstd decoder (`megapose6d_tpu_torch/native/zstd.cc`) against
the `zstandard` package: byte for byte on generated inputs at levels 1, 3,
9 and 19 (empty, 1 byte, all zeros, incompressible, text, float weights),
with and without the content checksum and the content size, two
concatenated frames, a skippable frame, a hypothesis sweep of sizes up to
4 MB, and every zstd frame of one committed checkpoint data file; and
the refusals: truncated frames, flipped bits under a checksum, a
dictionary ID, reserved bits, with ValueError.

Its encoder (`native.encode_zstd`): every frame decodes to its input
through libzstd (`zstandard`) and through the port's decoder, and declares
its content size: empty input, 1 byte, runs, zeros, random bytes, text,
sizes across the 128 KiB block limit, small and skewed alphabets (FSE-coded
Huffman weights, codes cut to 11 bits), repeats farther back than the
window, a hypothesis sweep; and on every array of `refiner_dr@24000` its
frames total at most 1.02 times libzstd's at level 1 (orbax's setting)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

zstandard = pytest.importorskip("zstandard")

from megapose6d_tpu_torch import native  # noqa: E402
from megapose6d_tpu_torch.utils.ocdbt import OcdbtStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "runs/coarse_dr/checkpoints/epoch_5000"
MAX = 1 << 30


def sample(kind: str, n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return bytes(n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "text":
        words = [b"render", b"and", b"compare", b"pose", b"mesh", b" ", b"\n", b"0.5", b"refiner"]
        return b"".join(words[i] for i in rng.integers(0, len(words), n))[:n]
    if kind == "weights":  # conv kernels as orbax stores them: float32, little endian
        return (rng.normal(size=n // 4 + 1) * 0.05).astype("<f4").tobytes()[:n]
    if kind == "runs":  # long matches, short literals, repeat offsets
        pieces = [rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes() * int(rng.integers(1, 30))
                  for _ in range(n // 200 + 1)]
        return b"".join(pieces)[:n]
    raise ValueError(kind)


def compress(data: bytes, level: int, checksum: bool = True, content_size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


def reference(frame: bytes) -> bytes:
    return zstandard.ZstdDecompressor().decompressobj(read_across_frames=True).decompress(frame)


@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("kind,n", [("zeros", 0), ("random", 1), ("zeros", 300_000), ("random", 200_000),
                                    ("text", 150_000), ("weights", 147_456), ("runs", 400_000)])
def test_levels_and_inputs(level, kind, n):
    data = sample(kind, n, seed=n + level)
    frame = compress(data, level)
    assert native.decode_zstd(frame, MAX) == data == zstandard.decompress(frame)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_checksum_and_content_size_flags(checksum, content_size):
    data = sample("runs", 700_000, seed=3) + sample("weights", 300_000, seed=4)
    frame = compress(data, 3, checksum, content_size)
    assert native.decode_zstd(frame, MAX) == data == reference(frame)
    out = np.empty(len(data), np.uint8)
    assert native.decode_zstd_into(frame, out) == len(data) and out.tobytes() == data


def test_concatenated_and_skippable_frames():
    a, b = sample("text", 90_000, seed=5), sample("random", 5_000, seed=6)
    skippable = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"ignored"
    stream = compress(a, 9) + skippable + compress(b, 1, content_size=False) + compress(b"", 3)
    assert native.decode_zstd(stream, MAX) == a + b == reference(stream)


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(n=st.integers(0, 4 << 20), kind=st.sampled_from(["random", "text", "weights", "runs", "zeros"]),
       level=st.sampled_from([1, 3, 9]), checksum=st.booleans(), content_size=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_sweep_of_sizes(n, kind, level, checksum, content_size, seed):
    data = sample(kind, n, seed)
    frame = compress(data, level, checksum, content_size)
    assert native.decode_zstd(frame, MAX) == data


def test_every_frame_of_a_committed_data_file():
    """Every indirect value of one data file of `runs/coarse_dr`'s
    checkpoint (the params' chunks, each a zstd frame)."""
    store = OcdbtStore(CHECKPOINT)
    values = [store.value(k) for k in store.list()]
    files = sorted({v.file for v in values if v.inline is None}, key=lambda f: (CHECKPOINT / f).stat().st_size)
    big = files[-1]
    keys = [k for k, v in zip(store.list(), values) if v.inline is None and v.file == big]
    assert len(keys) > 10
    for key in keys:
        frame = store.read(key)
        assert native.decode_zstd(frame, MAX) == zstandard.decompress(frame, max_output_size=MAX), key


def test_refuses_truncated_frames():
    data = sample("runs", 200_000, seed=8)
    frame = compress(data, 3)
    for cut in (1, 4, 5, 6, 9, 20, len(frame) // 2, len(frame) - 5, len(frame) - 1):
        with pytest.raises(ValueError):
            native.decode_zstd(frame[:cut], MAX)
    with pytest.raises(ValueError):
        native.decode_zstd(b"", MAX)


def test_refuses_flipped_bits_under_a_checksum():
    data = sample("random", 5_000, seed=9)  # a raw block: a flipped data bit decodes, and the checksum catches it
    frame = bytearray(compress(data, 1))
    for pos in (len(frame) - 1, len(frame) - 4, len(frame) // 2, len(frame) - 100):
        bad = bytearray(frame)
        bad[pos] ^= 0x10
        with pytest.raises(ValueError, match="checksum"):
            native.decode_zstd(bytes(bad), MAX)
    text = bytearray(compress(sample("text", 50_000, seed=10), 9))
    for pos in range(20, len(text) - 4, max(1, len(text) // 40)):  # compressed data: refused, one way or another
        bad = bytearray(text)
        bad[pos] ^= 0x04
        with pytest.raises(ValueError):
            native.decode_zstd(bytes(bad), MAX)


def test_refuses_dictionaries_and_reserved_bits():
    raw_block = (1 | (0 << 1) | (3 << 3)).to_bytes(3, "little") + b"abc"  # last, raw, 3 bytes
    magic = (0xFD2FB528).to_bytes(4, "little")
    plain = magic + bytes([0x00, 0x00]) + raw_block
    assert native.decode_zstd(plain, MAX) == b"abc" == zstandard.ZstdDecompressor().decompress(
        plain, max_output_size=16)
    with pytest.raises(ValueError, match="dictionary"):
        native.decode_zstd(magic + bytes([0x01, 0x00, 0x07]) + raw_block, MAX)  # dictionary ID 7
    with pytest.raises(ValueError, match="reserved"):
        native.decode_zstd(magic + bytes([0x08, 0x00]) + raw_block, MAX)  # the frame header's reserved bit
    with pytest.raises(ValueError, match="reserved"):
        native.decode_zstd(magic + bytes([0x00, 0x00]) + (1 | (3 << 1)).to_bytes(3, "little"), MAX)
    with pytest.raises(ValueError, match="not a zstd frame"):
        native.decode_zstd(b"\x00" * 16, MAX)


def test_refuses_more_than_max_size():
    data = sample("zeros", 100_000)
    with pytest.raises(ValueError):
        native.decode_zstd(compress(data, 1), 99_999)
    with pytest.raises(ValueError):
        native.decode_zstd(compress(data, 1, content_size=False), 50_000)
    with pytest.raises(ValueError):
        native.decode_zstd_into(compress(data, 1), np.empty(99_999, np.uint8))


def test_crc32c():
    assert native.crc32c(b"123456789") == 0xE3069283  # the check value of CRC-32C
    assert native.crc32c(b"") == 0


# -- the encoder -------------------------------------------------------------

def round_trip(data: bytes) -> bytes:
    frame = native.encode_zstd(data)
    assert zstandard.get_frame_parameters(frame).content_size == len(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert native.decode_zstd(frame, MAX) == data
    return frame


@pytest.mark.parametrize("kind,n", [("zeros", 0), ("random", 1), ("text", 31), ("text", 1023), ("zeros", 300_000),
                                    ("random", 200_000), ("text", 150_000), ("weights", 147_456), ("runs", 400_000),
                                    ("runs", 131_071), ("weights", 131_072), ("random", 131_073),
                                    ("text", 262_145), ("weights", 3_000_000)])
def test_encoder_round_trips(kind, n):
    round_trip(sample(kind, n, seed=n + 7))


@pytest.mark.parametrize("alphabet", [2, 3, 12, 40])
def test_encoder_small_and_skewed_alphabets(alphabet):
    """Few symbols (weights in 4 bits or FSE-coded) and geometric skews
    whose Huffman codes pass 11 bits before they are cut."""
    rng = np.random.default_rng(alphabet)
    round_trip(rng.integers(0, alphabet, 100_000, dtype=np.uint8).tobytes())
    p = 2.0 ** -np.arange(1, alphabet + 1)
    round_trip(rng.choice(np.arange(alphabet, dtype=np.uint8) * 5, 200_000, p=p / p.sum()).tobytes())


def test_encoder_repeats_beyond_the_window_and_blocks_of_one_byte():
    rng = np.random.default_rng(11)
    piece = rng.integers(0, 256, 1_500_000, dtype=np.uint8).tobytes()
    round_trip(piece * 2)  # the second copy lies 1.5 MB back, past the 1 MiB window
    frame = round_trip(bytes(1_000_000) + b"x" + bytes(1_000_000))
    assert len(frame) < 100


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(n=st.integers(0, 2 << 20), kind=st.sampled_from(["random", "text", "weights", "runs", "zeros"]),
       seed=st.integers(0, 2**31 - 1))
def test_encoder_sweep_of_sizes(n, kind, seed):
    round_trip(sample(kind, n, seed))


def test_encoder_on_the_committed_weights():
    """Every array of `refiner_dr@24000`: its frames decode to it, and in
    all they are within 2% of libzstd's level 1."""
    from megapose6d_tpu_torch.interop.orbax import array_leaves, read_checkpoint

    arrays = array_leaves(read_checkpoint(ROOT / "runs/refiner_dr/checkpoints/epoch_24000"))
    assert len(arrays) == 68
    ours = libzstd = 0
    for name, a in arrays.items():
        data = a.tobytes()
        ours += len(round_trip(data))
        libzstd += len(zstandard.ZstdCompressor(level=1).compress(data))
    assert ours <= 1.02 * libzstd, (ours, libzstd)
