"""Port parity: bit packing is bit-identical to ``repro.core.packing``,
including words whose bit 31 is set (negative int32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro_torch.core import packing

torch.set_num_threads(2)

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(1,), (31,), (32,), (33,), (80,), (3, 1000)])
def test_pack_bits_identical_to_reference(shape):
    t = _pm1(np.random.default_rng(sum(shape)), shape)
    want = np.asarray(jpacking.pack_bits(jnp.asarray(t)))
    got = packing.pack_bits(torch.from_numpy(t)).numpy()
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_bit31_words_round_trip():
    # all +1: every full word is 0xFFFFFFFF == -1 as int32
    t = np.ones((96,), np.float32)
    got = packing.pack_bits(torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), np.full((3,), -1, np.int32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpacking.pack_bits(jnp.asarray(t))))
    # only bit 31 set: INT32_MIN
    t = -np.ones((32,), np.float32)
    t[31] = 1.0
    assert packing.pack_bits(torch.from_numpy(t)).item() == -(2**31)
    back = packing.unpack_bits(torch.tensor([-(2**31), -1, 0x7FFFFFFF],
                                            dtype=torch.int32), 96)
    want = jpacking.unpack_bits(jnp.asarray([-(2**31), -1, 0x7FFFFFFF],
                                            jnp.int32), 96)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


@pytest.mark.parametrize("q", [1, 32, 45, 200])
def test_unpack_bits_identical_to_reference(q):
    rng = np.random.default_rng(q)
    words = rng.integers(-(2**31), 2**31, size=(4, packing.packed_len(q)),
                         dtype=np.int64).astype(np.int32)
    want = np.asarray(jpacking.unpack_bits(jnp.asarray(words), q))
    got = packing.unpack_bits(torch.from_numpy(words), q).numpy()
    np.testing.assert_array_equal(got, want)


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(q=st.integers(1, 300), seed=st.integers(0, 2**31 - 1))
def test_round_trip_and_reference_property(q, seed):
    t = _pm1(np.random.default_rng(seed), (q,))
    packed = packing.pack_bits(torch.from_numpy(t))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpacking.pack_bits(jnp.asarray(t))))
    np.testing.assert_array_equal(packing.unpack_bits(packed, q).numpy(), t)
