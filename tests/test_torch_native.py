"""The native host helpers (usearch_torch/native) on the CPU: the C++ key
map against the plain Python map over seeded random sequences, and the C++
casts against the JAX package's host route and the port's torch casts.

The native map, like the JAX package's, adds an entry when a key is
inserted again without ``multi``; `Index` never does that (it refuses
duplicate keys first), so the sequences insert only keys the map lacks
unless ``multi``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from usearch_tpu.enums import ScalarKind as JKind  # noqa: E402
from usearch_tpu.native import casts_native as jcasts_native  # noqa: E402
from usearch_tpu.ops import casts as jcasts  # noqa: E402

from usearch_torch import keymap  # noqa: E402
from usearch_torch.enums import ScalarKind  # noqa: E402
from usearch_torch.native import casts_native, keymap_native  # noqa: E402
from usearch_torch.ops import casts  # noqa: E402


def test_native_routes_load():
    """g++ is present here: both helpers build and the facades take them."""
    assert keymap.NATIVE and casts.NATIVE
    assert isinstance(keymap.KeyMap(), keymap_native.NativeKeyMap)


def same_maps(native, plain, probe):
    assert len(native) == len(plain)
    assert native.max_key() == plain.max_key()
    np.testing.assert_array_equal(np.sort(native.keys_array()), np.sort(plain.keys_array()))
    np.testing.assert_array_equal(native.contains_many(probe), plain.contains_many(probe))
    np.testing.assert_array_equal(native.count_many(probe), plain.count_many(probe))
    for k in probe[:40].tolist():
        assert sorted(native.slots_of(k)) == sorted(plain.slots_of(k))
        assert native.contains(k) == plain.contains(k) and native.count(k) == plain.count(k)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_map_matches_the_python_map(seed, multi):
    rng = np.random.default_rng(seed)
    native, plain = keymap_native.NativeKeyMap(multi), keymap._PyKeyMap(multi)
    assert native.max_key() == plain.max_key() == -1 and len(native) == 0
    next_slot = 0
    for step in range(30):
        op = rng.integers(0, 4)
        if op < 2:  # a batch insert; keys repeat with multi
            n = int(rng.integers(1, 400))
            keys = rng.integers(0, 2000 if multi else 1 << 40, n).astype(np.uint64)
            if not multi:
                keys = np.unique(keys)
                keys = keys[~plain.contains_many(keys)]
            slots = np.arange(next_slot, next_slot + len(keys), dtype=np.uint64)
            next_slot += len(keys)
            native.insert_many(keys, slots)
            plain.insert_many(keys, slots)
        elif op == 2:  # pops, of present and absent keys
            pool = plain.keys_array()
            picks = rng.choice(pool, size=min(len(pool), 25), replace=False) if len(pool) else pool
            for k in np.concatenate([picks, rng.integers(0, 1 << 40, 5).astype(np.uint64)]).tolist():
                assert sorted(native.pop(k)) == sorted(plain.pop(k))
        else:  # a copy goes on alone
            native_copy, plain_copy = native.copy(), plain.copy()
            k = int(plain.keys_array()[0]) if len(plain) else 7
            native_copy.pop(k)
            plain_copy.pop(k)
            same_maps(native_copy, plain_copy, np.array([k], dtype=np.uint64))
        probe = np.concatenate([plain.keys_array()[:200], rng.integers(0, 1 << 40, 50).astype(np.uint64)])
        same_maps(native, plain, probe.astype(np.uint64))


def quantizer_rows(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4096, 256)).astype(np.float32)
    x[0] = 0  # a zero row
    x[1] *= 1e30  # rescaled before squaring: no overflow
    x[2] = 0
    x[2, 7] = -3.0  # one nonzero: -127 exactly
    x[3] = 3.0e38  # the largest values
    x[4, ::2] = -1.0e-38  # tiny ones
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_native_i8_cast_is_the_reference_host_cast(seed):
    """Bit for bit the JAX package's own host route (its native cast), and
    within one step of its numpy quantizer: the native cast sums the norm
    in f64 and multiplies by the maximum's reciprocal, numpy sums in f32 and
    divides, which moves a few entries per ten million across a truncation
    boundary."""
    x = quantizer_rows(seed)
    got = casts_native.cast_f32_to_i8(x)
    np.testing.assert_array_equal(got, jcasts_native.cast_f32_to_i8(x))
    want = jcasts._i8_quantize(x, np)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.99999
    np.testing.assert_array_equal(got[:5], want[:5])


def test_host_batches_take_the_native_casts():
    """`cast_vectors` of host rows gives the native results: i8 rows bit
    for bit as the JAX package's host path casts them."""
    x = quantizer_rows(2)[:512, :100]
    got = casts.cast_vectors(x, ScalarKind.F32, ScalarKind.I8, 100).numpy()
    np.testing.assert_array_equal(got, jcasts.cast_vectors(x, JKind.F32, JKind.I8, 100))


def test_native_i8_widening_and_packing_match_the_torch_casts():
    rng = np.random.default_rng(3)
    q = rng.integers(-128, 128, (300, 96)).astype(np.int8)
    np.testing.assert_array_equal(casts_native.cast_i8_to_f32(q),
                                  casts.cast_rows(torch.from_numpy(q), ScalarKind.I8, ScalarKind.F32).numpy())
    f = rng.standard_normal((300, 100)).astype(np.float32)
    f[:, ::7] = 0.0  # zero is not > 0
    f[0] = -0.0
    for nbits in (100, 96, 3):
        packed = casts_native.pack_bits_f32(f[:, :nbits], (nbits + 7) // 8)
        want = casts.cast_rows(torch.from_numpy(f[:, :nbits]), ScalarKind.F32, ScalarKind.B1).numpy()
        np.testing.assert_array_equal(packed, want)
