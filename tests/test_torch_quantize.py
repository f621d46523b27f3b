"""PyTorch port parity: int8/uint8 quantization codes and params are
bit-equal to the JAX package's ops.quantize, non-finite elements included."""

import numpy as np
import pytest
import torch

from sqlite_vector_tpu.ops import quantize as jax_quantize
from sqlite_vector_tpu.types import QuantType as JaxQuantType
from sqlite_vector_tpu_torch.device import from_numpy
from sqlite_vector_tpu_torch.ops import quantize as port_quantize
from sqlite_vector_tpu_torch.types import QuantType


def data(seed, dtype, shift):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((257, 48)) * 3 + shift).astype(dtype)
    x[3, 5] = np.nan
    x[9, 0] = np.inf
    x[10, 7] = -np.inf
    x[40:44] = np.nan  # whole NaN rows
    return x


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("qtype", ["AUTO", "UINT8", "INT8"])
@pytest.mark.parametrize("shift", [0.0, 10.0])
@pytest.mark.nonfinite_inputs
def test_params_and_codes_bit_equal(dtype, qtype, shift):
    x = data(int(shift) + len(qtype), dtype, shift)
    x[:, 0] = np.clip(x[:, 0], -50, 50)  # keep the Inf columns from owning the range
    x[9, 0], x[10, 7] = 1.0, 2.0
    valid = 250  # rows >= valid are excluded from min/max
    jmn, jmx, jneg = jax_quantize.minmax_and_negative(x, valid)
    mn, mx, neg = port_quantize.minmax_and_negative(from_numpy(x), valid)
    assert (mn, mx, neg) == (float(jmn), float(jmx), bool(jneg))
    jq, js, jo = jax_quantize.resolve_quant_params(
        float(jmn), float(jmx), bool(jneg), JaxQuantType(qtype)
    )
    pq, ps, po = port_quantize.resolve_quant_params(mn, mx, neg, QuantType(qtype))
    assert pq.value == jq.value
    assert ps.tobytes() == js.tobytes() and po.tobytes() == jo.tobytes()
    x_nf = data(7, dtype, shift)  # codes of NaN/+-Inf elements too
    want = np.asarray(jax_quantize.quantize_device(x_nf, js, jo, jq))
    got = port_quantize.quantize_device(from_numpy(x_nf), ps, po, pq).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.nonfinite_inputs
def test_nonfinite_only_and_empty_ranges():
    """+-Inf-only columns clamp to FLT_MAX (no NaN scale); an all-NaN or
    empty range falls back to the reference's no-rows params."""
    x = np.full((4, 3), np.inf, np.float32)
    x[1] = -np.inf
    for valid in (4, 0):
        jmn, jmx, jneg = jax_quantize.minmax_and_negative(x, valid)
        mn, mx, neg = port_quantize.minmax_and_negative(from_numpy(x), valid)
        assert (mn, mx, neg) == (float(jmn), float(jmx), bool(jneg))
    nan = np.full((5, 2), np.nan, np.float32)
    jr = jax_quantize.minmax_and_negative(nan, 5)
    assert port_quantize.minmax_and_negative(from_numpy(nan), 5) == (
        float(jr[0]), float(jr[1]), bool(jr[2])
    )
    assert port_quantize.resolve_quant_params(*port_quantize.minmax_and_negative(
        from_numpy(nan), 5), QuantType.AUTO)[1:] == (np.float32(1.0), np.float32(0.0))


def test_q_round_half_away_from_zero_and_saturation():
    s = np.array(
        [-1e9, -128.5, -127.5, -2.5, -0.5, -0.49, 0.0, 0.49, 0.5, 2.5, 126.5, 127.5, 255.5, 1e9,
         np.nan, np.inf, -np.inf],
        np.float32,
    )
    for lo, hi in ((0.0, 255.0), (-128.0, 127.0)):
        want = np.asarray(jax_quantize._q_round(s, lo, hi))
        got = port_quantize._q_round(torch.from_numpy(s), lo, hi).numpy()
        np.testing.assert_array_equal(got, want)


def test_quantize_device_requires_resolved_qtype():
    with pytest.raises(ValueError):
        port_quantize.quantize_device(torch.zeros(2, 2), 1.0, 0.0, QuantType.AUTO)
