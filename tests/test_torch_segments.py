"""Sorted-segment machinery: cylon_tpu_torch.ops.segments against
cylon_tpu.ops.segments on the same inputs, narrow mode (the port's scans
against the reference's Pallas scans) and wide mode (torch's and XLA's own
scans and scatters).

Tolerances: exact for positions, counts and integer sums; float32 sums
rtol=1e-5 (prefix sums and segmented scans round in different orders on
the two sides), plus a few ulps of the column's whole prefix for sums
taken as prefix-sum differences; float64 sums rtol=1e-12."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import segments as rseg
from cylon_tpu_torch.ops import segments

from .torch_parity import modes, np_of


def _runs(rng, n, p_start=0.1):
    new_group = rng.random(n) < p_start
    new_group[0] = True
    is_run_end = np.roll(new_group, -1)
    is_run_end[-1] = True
    return new_group, is_run_end


def _spans(new_group):
    start, end = segments.segment_spans(torch.from_numpy(new_group))
    return start, end


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_run_extents_matches_reference(mode):
    rng = np.random.default_rng(31)
    for n in (1, 300, 20000):
        member = rng.random(n) < 0.5
        new_group, is_run_end = _runs(rng, n)
        with modes(mode):
            r_start, r_cnt = rseg.run_extents(
                jnp.asarray(member), jnp.asarray(new_group),
                jnp.asarray(is_run_end))
            p_start, p_cnt = segments.run_extents(
                torch.from_numpy(member), torch.from_numpy(new_group),
                torch.from_numpy(is_run_end))
        np.testing.assert_array_equal(np_of(p_start), np.asarray(r_start))
        np.testing.assert_array_equal(np_of(p_cnt), np.asarray(r_cnt))
        assert p_start.dtype == torch.int32


@pytest.mark.parametrize("permute", ["scatter", "sort"])
def test_segment_spans_matches_reference(permute, monkeypatch):
    # only the reference reads the knob: the port's one realization
    # against each of the reference's
    monkeypatch.setenv("CYLON_TPU_PERMUTE", permute)
    rng = np.random.default_rng(37)
    for n in (1, 2, 999):
        new_group, _ = _runs(rng, n, 0.2)
        r_start, r_end = rseg.segment_spans(jnp.asarray(new_group))
        p_start, p_end = _spans(new_group)
        np.testing.assert_array_equal(np_of(p_start), np.asarray(r_start))
        np.testing.assert_array_equal(np_of(p_end), np.asarray(r_end))


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("kind", ["f32", "f64", "i32", "i64"])
def test_segment_sum_sorted_matches_reference(mode, kind):
    rng = np.random.default_rng(41)
    n = 3000
    dt = {"f32": np.float32, "f64": np.float64, "i32": np.int32,
          "i64": np.int64}[kind]
    x = (rng.random(n) * 100).astype(dt)
    new_group, _ = _runs(rng, n)
    with modes(mode):
        r_start, r_end = rseg.segment_spans(jnp.asarray(new_group))
        exp = np.asarray(rseg.segment_sum_sorted(jnp.asarray(x), r_start,
                                                 r_end))
        p_start, p_end = _spans(new_group)
        got = np_of(segments.segment_sum_sorted(torch.from_numpy(x), p_start,
                                                p_end))
    assert got.dtype == exp.dtype
    if kind == "f32" or (kind == "f64" and mode == "narrow"):
        # float32 prefix-sum differences: each side rounds its running
        # prefix in its own order, so a segment sum may be off by a few
        # ulps of the whole column's prefix, not of the segment's sum
        atol = 4 * float(np.spacing(np.float32(np.abs(x).sum())))
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=atol)
    elif kind == "f64":
        np.testing.assert_allclose(got, exp, rtol=1e-12)  # float64 sums
    else:
        np.testing.assert_array_equal(got, exp)  # integer sums: exact


def test_segment_count_sorted_matches_reference():
    rng = np.random.default_rng(43)
    n = 2500
    valid = rng.random(n) < 0.7
    new_group, _ = _runs(rng, n)
    r_start, r_end = rseg.segment_spans(jnp.asarray(new_group))
    p_start, p_end = _spans(new_group)
    exp = np.asarray(rseg.segment_count_sorted(jnp.asarray(valid), r_start,
                                               r_end))
    got = np_of(segments.segment_count_sorted(torch.from_numpy(valid),
                                              p_start, p_end))
    assert got.dtype == exp.dtype == np.int64
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_segmented_reduce_sorted_matches_pallas_path(op, dtype):
    dt = np.float32 if dtype == "f32" else np.int32
    rng = np.random.default_rng(47)
    for n in (1, 130, 10000):
        x = (rng.random(n) * 100).astype(dt)
        new_group, _ = _runs(rng, n, 0.01)
        with modes("narrow"):
            r_start, r_end = rseg.segment_spans(jnp.asarray(new_group))
            exp = np.asarray(rseg.segmented_reduce_sorted(
                jnp.asarray(x), jnp.asarray(new_group), r_end, op))
            _, p_end = _spans(new_group)
            got = np_of(segments.segmented_reduce_sorted(
                torch.from_numpy(x), torch.from_numpy(new_group), p_end, op))
        if dt == np.float32 and op == "sum":
            np.testing.assert_allclose(got, exp, rtol=1e-5)  # float32 sum
        else:
            np.testing.assert_array_equal(got, exp)  # exact
