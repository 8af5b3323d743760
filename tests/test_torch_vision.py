"""The vision ops, port against the JAX package's lowerings on the same
numpy inputs (tests/test_torch_conv_rest.py's run_op): lrn, roi_pool,
crop, max_pool2d_with_index and unpool, forward and gradient, fp32 and
bf16. Where the reference's result is exact (max, argmax, crop, unpool
on distinct indices) the check is bit for bit, on feeds with ties, with
windows and bins whose values are all -inf (the reference fills outside
them with finfo.min), with empty ROI bins and with crop offsets that must
be clamped. The max gradients are the reference's: shared evenly among
the tied elements (JAX's reduce_max), which F.max_pool2d and torch.max
do not do."""

import numpy as np
import pytest

from paddle_tpu.ops import vision_ops as jvis
from paddle_tpu_torch.ops import vision_ops as tvis

from test_torch_conv_rest import close, run_op

LRN = (jvis._lrn, tvis._lrn)
ROI = (jvis._roi_pool, tvis._roi_pool)
CROP = (jvis._crop, tvis._crop)
MAXPOOL = (jvis._max_pool2d_with_index, tvis._max_pool2d_with_index)
UNPOOL = (jvis._unpool, tvis._unpool)


def exact(pairs):
    for i, (r, g) in enumerate(pairs):
        assert r.shape == g.shape, i
        assert np.array_equal(r.astype(np.float64), g.astype(np.float64),
                              equal_nan=True), i


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('n', [5, 3, 4])
def test_lrn_matches_reference(n, amp):
    """lrn's n + 1 taps (the reference's window is inclusive at both ends)
    added to k in its order: MidOut bit for bit at fp32, Out within 1e-6
    (the power), and the gradient; bf16 X runs in bf16."""
    rng = np.random.RandomState(n)
    x = (3.0 * rng.randn(2, 7, 4, 5)).astype('float32')
    pairs = run_op(LRN, 'lrn', {'X': x}, ['Out', 'MidOut'],
                   dict(n=n, k=2.0, alpha=1e-2, beta=0.75), amp=amp,
                   grad=['X'], bf16_in=('X',) if amp else ())
    if amp is None:
        exact(pairs[1:2])
    close(pairs, 1e-6, bf16=amp is not None, grad_from=2)


def roi_inputs(seed, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 9, 11).astype('float32')
    if ties:
        x = np.maximum(np.round(x), 0.0).astype('float32')
    rois = np.array([[0, 1, 1, 5, 6], [1, 0, 0, 10, 8], [0, 3, 3, 3, 3],
                     [1, 2, 4, 9, 8], [0, -3, 2, 20, 5], [1, 0, 0, 21, 17]],
                    'int64')
    return x, rois


@pytest.mark.parametrize('ties', [False, True], ids=['random', 'ties'])
@pytest.mark.parametrize('scale', [1.0, 0.5])
def test_roi_pool_matches_reference(scale, ties):
    """Out and Argmax bit for bit (the first maximal h·W + w in row-major
    order); the gradient shared among tied elements, summed over the ROIs
    of each image. 'ties': a rounded ReLU map, most bins tie at 0 or 1."""
    x, rois = roi_inputs(3, ties)
    pairs = run_op(ROI, 'roi_pool', {'X': x, 'ROIs': rois},
                   ['Out', 'Argmax'],
                   dict(pooled_height=3, pooled_width=2,
                        spatial_scale=scale), grad=['X'])
    exact(pairs[:2])
    close(pairs[2:], 1e-6)


def test_roi_pool_fill_value_and_empty_bins():
    """A bin whose own values are all -inf gives finfo.min (the
    reference's fill outside the bin) and its argmax the first position
    outside it; a bin clipped to nothing (an ROI past the map) gives 0
    and Argmax -1."""
    x, _ = roi_inputs(4)
    x[0, :, 2:5, 3:7] = -np.inf
    rois = np.array([[0, 3, 2, 6, 4], [0, 30, 30, 40, 40],
                     [1, 0, 0, 10, 8]], 'int64')
    pairs = run_op(ROI, 'roi_pool', {'X': x, 'ROIs': rois},
                   ['Out', 'Argmax'],
                   dict(pooled_height=2, pooled_width=2, spatial_scale=1.0),
                   grad=['X'])
    exact(pairs[:2])
    out, arg = pairs[0][1], pairs[1][1]
    assert (out[0] == np.finfo(np.float32).min).all()
    assert (arg[0] == 0).all()               # (0, 0) lies outside the bins
    assert (out[1] == 0).all() and (arg[1] == -1).all()
    close(pairs[2:], 1e-6)


def test_roi_pool_bf16():
    """A bf16 map: Out bit for bit (max is exact in any dtype), Argmax
    equal, the gradient within bf16's rounding of the shares."""
    x, rois = roi_inputs(5, ties=True)
    pairs = run_op(ROI, 'roi_pool', {'X': x, 'ROIs': rois},
                   ['Out', 'Argmax'],
                   dict(pooled_height=2, pooled_width=3, spatial_scale=1.0),
                   amp='bf16', grad=['X'], bf16_in=('X',))
    exact(pairs[:2])
    close(pairs[2:], 0.0, bf16=True, grad_from=0)


POOL_CASES = [  # (ksize, strides, paddings)
    ([2, 2], [2, 2], [0, 0]),
    ([3, 3], [2, 2], [1, 1]),
    ([3, 2], [1, 1], [1, 0]),
    ([2, 3], [2, 1], [1, 1]),
]


@pytest.mark.parametrize('ties', [False, True], ids=['random', 'ties'])
@pytest.mark.parametrize('case', POOL_CASES)
def test_max_pool2d_with_index_matches_reference(case, ties):
    """Out and Mask bit for bit (Mask: the flattened index of each
    window's first maximal tap, from the clipped padding taps where a
    window reaches past the map), the gradient shared among the taps tied
    at the max (overlapping windows sum)."""
    ksize, strides, pads = case
    rng = np.random.RandomState(len(pads) + strides[1])
    x = rng.randn(2, 3, 7, 8).astype('float32')
    if ties:
        x = np.maximum(np.round(x), 0.0).astype('float32')
    pairs = run_op(MAXPOOL, 'max_pool2d_with_index', {'X': x},
                   ['Out', 'Mask'],
                   dict(ksize=ksize, strides=strides, paddings=pads),
                   grad=['X'])
    exact(pairs[:2])
    close(pairs[2:], 1e-6)


def test_max_pool2d_with_index_all_minus_inf_windows():
    """A window whose taps are all -inf: Out is finfo.min, the padding's
    fill, and Mask the clipped index of its first padding tap, as the
    reference gives; bf16 too."""
    x = np.random.RandomState(8).randn(1, 2, 6, 6).astype('float32')
    x[0, 0, :3, :3] = -np.inf
    for amp in (None, 'bf16'):
        pairs = run_op(MAXPOOL, 'max_pool2d_with_index', {'X': x},
                       ['Out', 'Mask'],
                       dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
                       amp=amp, bf16_in=('X',) if amp else ())
        exact(pairs)
        assert pairs[0][1][0, 0, 0, 0] == pairs[0][0][0, 0, 0, 0] < -1e38


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
def test_pool_unpool_round_trip_is_exact(amp):
    """max_pool2d_with_index then unpool at 2 x 2, stride 2 (SegNet's
    pooling): the windows do not overlap, so the indices are distinct and
    the map, its gradient and the round trip are the reference's bit for
    bit."""
    x = np.random.RandomState(9).randn(2, 3, 8, 10).astype('float32')
    attrs = dict(ksize=[2, 2], strides=[2, 2], paddings=[0, 0])
    pooled = run_op(MAXPOOL, 'max_pool2d_with_index', {'X': x},
                    ['Out', 'Mask'], attrs, amp=amp,
                    bf16_in=('X',) if amp else ())
    exact(pooled)
    vals, mask = pooled[0][0], pooled[1][0]
    pairs = run_op(UNPOOL, 'unpool', {'X': vals, 'Indices': mask}, ['Out'],
                   attrs, amp=amp, grad=['X'],
                   bf16_in=('X',) if amp else ())
    exact(pairs)
    out = pairs[0][1]
    assert out.shape == x.shape
    assert np.count_nonzero(out) == np.count_nonzero(vals)


def test_unpool_repeated_indices_write_one_candidate():
    """Overlapping windows (3 x 3, stride 1) repeat indices. XLA does not
    define which of a repeated index's writes wins, so where indices
    repeat each written position holds one of the values written there;
    a position written once equals the reference bit for bit, an index
    never written is 0, and the gradient goes to one write of each
    position."""
    x = np.random.RandomState(10).randn(1, 2, 7, 7).astype('float32')
    attrs = dict(ksize=[3, 3], strides=[1, 1], paddings=[0, 0])
    pooled = run_op(MAXPOOL, 'max_pool2d_with_index', {'X': x},
                    ['Out', 'Mask'], attrs)
    vals, mask = pooled[0][0], pooled[1][0]
    vals = vals + np.arange(vals.size, dtype='float32').reshape(vals.shape)
    ((ref, got), (_, grad)) = run_op(UNPOOL, 'unpool',
                                     {'X': vals, 'Indices': mask}, ['Out'],
                                     attrs, grad=['X'])
    flat_v, flat_i = vals.reshape(2, -1), mask.reshape(2, -1)
    for row in range(2):
        for pos in range(ref.shape[2] * ref.shape[3]):
            cand = flat_v[row][flat_i[row] == pos]
            have = got.reshape(2, -1)[row, pos]
            if cand.size == 0:
                assert have == 0 == ref.reshape(2, -1)[row, pos]
            else:
                assert have in cand
            if cand.size == 1:
                assert have == ref.reshape(2, -1)[row, pos]
    assert np.count_nonzero(grad) == len(
        {(r, p) for r in range(2) for p in flat_i[r]})


@pytest.mark.parametrize('offsets', [[1, 2, 4, 1], [0, 0, 0, 0],
                                     [5, -3, 9, 7]])
def test_crop_with_offsets_input_clamps(offsets):
    """An Offsets input is lax.dynamic_slice: the start is clamped so the
    crop stays inside X ([5, -3, 9, 7] starts at [1, 0, 3, 2]); values
    and gradient bit for bit."""
    x = np.random.RandomState(11).randn(2, 3, 8, 8).astype('float32')
    pairs = run_op(CROP, 'crop', {'X': x, 'Offsets': np.array(offsets,
                                                              'int32')},
                   ['Out'], dict(shape=[1, 2, 5, 6]), grad=['X'])
    exact(pairs)


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
def test_crop_static_and_like_y(amp):
    """Static offsets from the attribute, and the target shape from Y."""
    rng = np.random.RandomState(12)
    x = rng.randn(3, 5, 6).astype('float32')
    bf16 = ('X',) if amp else ()
    exact(run_op(CROP, 'crop', {'X': x}, ['Out'],
                 dict(shape=[2, 3, 4], offsets=[1, 2, 1]), amp=amp,
                 grad=['X'], bf16_in=bf16))
    exact(run_op(CROP, 'crop', {'X': x, 'Y': np.zeros((2, 4, 4), 'f')},
                 ['Out'], dict(offsets=[0, 1, 1]), amp=amp, grad=['X'],
                 bf16_in=bf16))
