"""The Philox4x32-10 keep-masks of the port's in-kernel dropout
(``eegflow_torch.nn.philox``): Random123's known answers, masks keyed by the
element (any row block drawn at its offset is the whole batch's rows), the
key's effect, and the masks' statistics (each stream's keep fraction, the
independence of streams and keys), as ``chip_smoke.py`` phase 25 checks
them at full size on the card; the packed keep-bit plane the draw kernel
(``csrc/philox_bits.cu``) writes, through its twin. The threshold is the
reference's ``_keep_threshold``."""

import math

import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import _keep_threshold
from eegflow_torch.nn.philox import (PhiloxBits, PhiloxSource, draw_keep_bits, keep_threshold,
                                     philox4x32, philox_keep_bits, philox_keep_mask,
                                     unpack_keep_bits)

# Random123's known-answer vectors for philox4x32-10 (kat_vectors): counter,
# key, the four output words
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
KEY = torch.tensor([-123456789, 987654321], dtype=torch.int32)
OTHER_KEY = torch.tensor([-123456789, 987654322], dtype=torch.int32)
# the mask-path shape of a layer's part, cut to a CPU test: B, T, H
SHAPE = (24, 64, 64)


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox4x32_10_gives_random123s_known_answers(counter, key, want):
    got = philox4x32(tuple(torch.tensor(c, dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("keep", [0.6, 0.8, 1.0, 1.0 - 2.0 ** -33, 0.5 + 2.0 ** -40])
def test_keep_threshold_is_the_references(keep):
    assert keep_threshold(keep) == int(_keep_threshold(keep))


def test_the_twin_counts_words_as_the_kernels_do():
    """Element i reads word i & 3 of the block at counter (i >> 2, 0,
    stream, 0): the first eight elements of stream 5 from two blocks."""
    words = [w for q in range(2)
             for w in philox4x32(tuple(torch.tensor(v) for v in (q, 0, 5, 0)),
                                 tuple(int(w) & 0xFFFFFFFF for w in KEY))]
    thresh = keep_threshold(0.6)
    want = torch.tensor([int(w) < thresh for w in words])
    assert torch.equal(philox_keep_mask(KEY, 5, (1, 1, 8), 0.6), want.reshape(1, 1, 8))


@pytest.mark.parametrize("a,b", [(0, 5), (7, 24), (13, 14), (3, 21)])
@pytest.mark.parametrize("width", [64, 61, 37])
def test_rows_drawn_at_their_offset_are_the_whole_batchs_rows(a, b, width):
    """A mask bit is a function of the element's place in the whole batch:
    rows [a, b) drawn with row_offset=a equal rows a..b of the whole, at
    widths whose rows do not start at a block of four."""
    shape = (SHAPE[0], 9, width)
    whole = philox_keep_mask(KEY, 3, shape, 0.6)
    assert torch.equal(philox_keep_mask(KEY, 3, (b - a, 9, width), 0.6, row_offset=a),
                       whole[a:b])


def test_one_key_repeats_and_another_key_or_stream_differs():
    m = philox_keep_mask(KEY, 1, SHAPE, 0.6)
    assert torch.equal(m, philox_keep_mask(KEY.clone(), 1, SHAPE, 0.6))
    assert not torch.equal(m, philox_keep_mask(OTHER_KEY, 1, SHAPE, 0.6))
    assert not torch.equal(m, philox_keep_mask(KEY, 2, SHAPE, 0.6))
    # a lower keep drops a superset: the same words against a lower threshold
    low = philox_keep_mask(KEY, 1, SHAPE, 0.4)
    assert bool((m | ~low).all()) and low.sum() < m.sum()


def binomial_z(kept: int, n: int, p: float) -> float:
    return (kept - n * p) / math.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("stream,keep", [(0, 0.8), (1, 0.6), (2, 0.6), (4, 0.6)])
def test_each_streams_keep_fraction_is_within_5_sigma_of_its_binomial(stream, keep):
    m = philox_keep_mask(KEY, stream, SHAPE, keep)
    assert abs(binomial_z(int(m.sum()), m.numel(), keep)) < 5


@pytest.mark.parametrize("pair", [((KEY, 1), (KEY, 2)), ((KEY, 1), (KEY, 4)),
                                  ((KEY, 2), (OTHER_KEY, 2))])
def test_streams_and_keys_agree_as_independent_masks_do(pair):
    """Two independent masks of keep p agree on a fraction p^2 + (1 - p)^2
    of the elements (within 5 sigma)."""
    (k0, s0), (k1, s1) = pair
    keep = 0.6
    a = philox_keep_mask(k0, s0, SHAPE, keep)
    b = philox_keep_mask(k1, s1, SHAPE, keep)
    p = keep ** 2 + (1 - keep) ** 2
    assert abs(binomial_z(int((a == b).sum()), a.numel(), p)) < 5


def test_a_source_expands_one_uint8_mask_per_part():
    xs = (torch.zeros(4, 5, 16), torch.zeros(4, 5, 16))
    src = PhiloxSource(KEY, (3, 4), row_offset=8)
    got = src.masks(xs, 0.6)
    assert all(m.dtype == torch.uint8 and m.shape == x.shape for m, x in zip(got, xs))
    for m, s in zip(got, (3, 4)):
        assert torch.equal(m.bool(), philox_keep_mask(KEY, s, (4, 5, 16), 0.6, 8))
    with pytest.raises(ValueError, match="streams"):
        PhiloxSource(KEY, (3,)).masks(xs, 0.6)
    with pytest.raises(ValueError, match="int32"):
        philox_keep_mask(KEY.to(torch.int64), 0, (1, 1, 4), 0.6)
    np.testing.assert_array_equal(philox_keep_mask(KEY, 0, (2, 3, 4), 1.0).numpy(), True)


# a row offset whose part straddles element 2^34 = counter word 2^32 at a
# (3, 5, 7) part: 44 elements before it, 61 after
PAST_2_32 = 2 ** 34 // 35 - 1


@pytest.mark.parametrize("shape,row_offset", [((3, 5, 7), 0), ((2, 3, 11), 5), ((1, 1, 37), 2),
                                              ((4, 8, 16), 3), ((3, 5, 7), PAST_2_32)])
def test_the_plane_unpacks_to_the_mask(shape, row_offset):
    """Bit i mod 8 of byte i / 8 is element i's keep bit, in 4 ceil(n / 32)
    bytes whose bits past the part are 0: at element counts that are not a
    multiple of 8 or 32, at a row offset, and across the 2^32 counter word."""
    n = math.prod(shape)
    bits = philox_keep_bits(KEY, 3, shape, 0.6, row_offset)
    assert bits.dtype == torch.uint8 and bits.shape == (4 * -(-n // 32),)
    mask = philox_keep_mask(KEY, 3, shape, 0.6, row_offset)
    assert torch.equal(unpack_keep_bits(bits, shape), mask)
    flat = mask.reshape(-1)
    for i in (0, n // 3, n - 1):
        assert (int(bits[i // 8]) >> (i % 8)) & 1 == int(flat[i])
    tail = (bits[:, None].to(torch.int32) >> torch.arange(8)).reshape(-1)[n:] & 1
    assert int(tail.sum()) == 0


def test_the_element_at_2_34_reads_counter_word_2_32():
    """Element 2^34 of a stream (row PAST_2_32 + 1 of a (B, 5, 7) part, plus
    9) is word 0 of the block at counter (0, 1, stream, 0), and the element
    before it word 3 of the block at (2^32 - 1, 0, stream, 0)."""
    thresh = keep_threshold(0.6)
    key = tuple(int(w) & 0xFFFFFFFF for w in KEY)
    at = 2 ** 34 - PAST_2_32 * 35
    after = philox4x32(tuple(torch.tensor(v) for v in (0, 1, 3, 0)), key)[0]
    before = philox4x32(tuple(torch.tensor(v) for v in (2 ** 32 - 1, 0, 3, 0)), key)[3]
    flat = unpack_keep_bits(philox_keep_bits(KEY, 3, (3, 5, 7), 0.6, PAST_2_32),
                            (3, 5, 7)).reshape(-1)
    assert bool(flat[at]) == (int(after) < thresh)
    assert bool(flat[at - 1]) == (int(before) < thresh)


def test_draw_keep_bits_on_the_cpu_is_the_twin_per_part():
    xs = (torch.zeros(3, 4, 9), torch.zeros(3, 4, 9))
    src = PhiloxSource(KEY, (5, 6), row_offset=7)
    drawn = draw_keep_bits(src, xs, 0.7)
    assert isinstance(drawn, PhiloxBits) and drawn.source is src and drawn.keep == 0.7
    for plane, s in zip(drawn.planes, (5, 6)):
        assert torch.equal(plane, philox_keep_bits(KEY, s, (3, 4, 9), 0.7, 7))
    with pytest.raises(ValueError, match="streams"):
        draw_keep_bits(PhiloxSource(KEY, (5,)), xs, 0.7)
