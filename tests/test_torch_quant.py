"""The port's §5.3 fixed-point oracle against ``repro.core.quant``'s on
the same numpy inputs: ``quantize``, ``dequantize``, ``qmatmul`` (bias,
relu, saturation at both ends) and ``validate_layerwise`` (its RMS,
an f32 sum, exactly where the squares sum exactly), each exactly equal,
for Q8.8 and Q5.11."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jq  # noqa: E402

from repro_torch.core import quant as tq  # noqa: E402

FORMATS = {"q8_8": (tq.Q8_8, jq.Q8_8), "q5_11": (tq.Q5_11, jq.Q5_11)}


def _floats(fmt, shape, seed, spread=1.5):
    """Values over the format's range and past it at both ends, plus the
    round-half cases (k + 0.5 LSB) and the exact extremes."""
    rng = np.random.default_rng(seed)
    top = fmt.qmax / fmt.scale
    x = rng.uniform(-spread * top, spread * top, shape).astype(np.float32)
    flat = x.reshape(-1)
    halves = (np.arange(-4, 4) + 0.5) / fmt.scale
    flat[:8] = halves
    flat[8:12] = [fmt.qmin / fmt.scale, top, 4 * top, -4 * top]
    return x


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_qformat_fields_match(name):
    ours, ref = FORMATS[name]
    assert (ours.int_bits, ours.frac_bits, ours.total_bits, ours.scale,
            ours.qmin, ours.qmax) == (ref.int_bits, ref.frac_bits,
                                      ref.total_bits, ref.scale, ref.qmin,
                                      ref.qmax)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_quantize_and_dequantize_match_reference_exactly(name):
    ours, ref = FORMATS[name]
    x = _floats(ours, (7, 33), seed=1)
    got = tq.quantize(torch.from_numpy(x), ours)
    want = np.asarray(jq.quantize(jnp.asarray(x), ref))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min().item() == ours.qmin and got.max().item() == ours.qmax
    np.testing.assert_array_equal(
        tq.dequantize(got, ours).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(want), ref)))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_qmatmul_matches_reference_exactly(name, bias, relu):
    ours, ref = FORMATS[name]
    rng = np.random.default_rng(2)
    a = tq.quantize(torch.from_numpy(_floats(ours, (9, 40), 3, 1.0)), ours)
    b = tq.quantize(torch.from_numpy(_floats(ours, (40, 11), 4, 1.0)), ours)
    bq = (tq.quantize(torch.from_numpy(
        rng.uniform(-4, 4, 11).astype(np.float32)), ours) if bias else None)
    got = tq.qmatmul(a, b, ours, bias_q=bq, relu=relu)
    want = np.asarray(jq.qmatmul(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), ref,
        bias_q=None if bq is None else jnp.asarray(bq.numpy()), relu=relu))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    # Products this wide saturate: both ends are reached (the lower one
    # only without the relu).
    assert got.max().item() == ours.qmax
    assert got.min().item() == (0 if relu else ours.qmin)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_qmatmul_small_products_shift_with_floor(name):
    """Values well inside the range: the one arithmetic right shift
    floors negative sums, as the reference's int32 shift does."""
    ours, ref = FORMATS[name]
    rng = np.random.default_rng(5)
    a = rng.integers(-300, 300, (6, 5)).astype(np.int16)
    b = rng.integers(-300, 300, (5, 4)).astype(np.int16)
    got = tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), ours)
    want = np.asarray(jq.qmatmul(jnp.asarray(a), jnp.asarray(b), ref))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 0).any() and (np.abs(want) < ours.qmax).all()


def _layers(ours, ref, seed, dyadic):
    """Float layers and their fixed-point counterparts (int16 from the
    reference's ``quantize``, plus one float layer).  ``dyadic`` draws
    the floats on a grid of a quarter LSB, so every error and square is
    exact in f32 and a sum of them is the same in any order."""
    rng = np.random.default_rng(seed)
    floats, quants = [], []
    for shape in [(4, 8), (16,), (3, 5, 7)]:
        f = rng.uniform(-2, 2, shape).astype(np.float32)
        if dyadic:
            f = (np.round(f * 4 * ours.scale) / (4 * ours.scale)).astype(
                np.float32)
        floats.append(f)
        quants.append(np.array(jq.quantize(jnp.asarray(f), ref)))
    floats.append(rng.uniform(-1, 1, (8,)).astype(np.float32))
    quants.append(floats[-1] + np.float32(1 / 1024))   # a float layer
    got = tq.validate_layerwise([torch.from_numpy(f) for f in floats],
                                [torch.from_numpy(q) for q in quants], ours)
    want = jq.validate_layerwise([jnp.asarray(f) for f in floats],
                                 [jnp.asarray(q) for q in quants], ref)
    assert [r["layer"] for r in got] == [0, 1, 2, 3]
    return got, want


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_validate_layerwise_matches_reference_exactly(name):
    got, want = _layers(*FORMATS[name], seed=6, dyadic=True)
    assert got == want
    assert all(r["max_abs_err_lsb"] in (0.0, 0.25, 0.5) for r in got[:3])


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_validate_layerwise_on_any_floats(name):
    """On arbitrary floats the largest error is the same float; the RMS
    sums f32 squares in PyTorch's order rather than XLA's, so it may
    differ in its last bits (relative 2^-22)."""
    got, want = _layers(*FORMATS[name], seed=7, dyadic=False)
    for g, w in zip(got, want):
        assert g["max_abs_err_lsb"] == w["max_abs_err_lsb"]
        assert g["rms_err_lsb"] == pytest.approx(w["rms_err_lsb"],
                                                 rel=2.0 ** -22, abs=0)
