"""The detection ops, layers and the SSD model, port vs reference, on the
CPU: every detection op through the parity harness
(test_torch_harness.check_parity: the reference's program loaded into
the port, every op's output and every input's gradient compared) on a
random and an edge feed (identical, nested, touching, disjoint and
zero-area boxes, tied distances and scores, rows with no match); the 11
cases of tests/test_detection.py built in both packages; models/ssd.py
trained 3 Adam steps at 3 x 64 x 64 and 4 classes from the reference
startup's weights, and its detections.

Tolerances: the harness's rule (fp32, pointwise 1e-6 of the output's
scale); the mirrored cases' integer outputs exact and float outputs
rtol 1e-5; SSD losses rtol 1e-5; detections: labels exact, boxes and
scores atol 1e-5.
"""

import importlib

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)

import paddle_tpu as fluid

from test_torch_control_flow import run_both
from test_torch_harness import check_parity


def _boxes(rng, shape, lo=0.0, hi=0.7, size=(0.05, 0.3)):
    """Corner boxes [..., 4] with x0 < x1, y0 < y1."""
    corner = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(size[0], size[1], shape + (2,))
    return np.concatenate([corner, corner + wh], -1).astype(np.float32)


# the edge boxes: a prior itself, nested in it, touching it, disjoint,
# zero area, zero width, a unit box, an inverted one
PRIORS_EDGE = np.array([[0.1, 0.1, 0.5, 0.5], [0.5, 0.1, 0.9, 0.5],
                        [0.0, 0.0, 1.0, 1.0], [0.3, 0.3, 0.3, 0.3],
                        [0.6, 0.6, 0.8, 0.9], [0.2, 0.6, 0.4, 0.8]],
                       np.float32)
GT_EDGE = np.array([[[0.1, 0.1, 0.5, 0.5], [0.2, 0.2, 0.4, 0.4],
                     [0.5, 0.5, 0.5, 0.9], [0.0, 0.0, 1.0, 1.0],
                     [0.9, 0.9, 0.95, 0.95]],
                    [[0.5, 0.1, 0.9, 0.5], [0.3, 0.3, 0.3, 0.3],
                     [0.6, 0.6, 0.8, 0.9], [0.7, 0.2, 0.6, 0.4],
                     [0.1, 0.1, 0.5, 0.5]]], np.float32)


def _iou_feed(kind, batched=True):
    if kind == 'edge':
        x = GT_EDGE if batched else GT_EDGE[0]
        return {'x': x, 'y': PRIORS_EDGE}
    rng = np.random.RandomState(11)
    return {'x': _boxes(rng, (2, 5) if batched else (5,)),
            'y': _boxes(rng, (6,))}


def _coder_feed(kind, code_type):
    rng = np.random.RandomState(12)
    prior = PRIORS_EDGE[[0, 1, 2, 4, 5, 0]] if kind == 'edge' else \
        _boxes(rng, (6,), size=(0.1, 0.3))
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (6, 1))
    if code_type == 'encode_center_size':
        target = np.concatenate([prior[:2], _boxes(rng, (1,))]) \
            if kind == 'edge' else _boxes(rng, (3,), size=(0.1, 0.3))
    elif code_type == 'encode_aligned':
        target = np.stack([prior, prior[::-1]]).copy()
        if kind == 'edge':
            target[1, 3] = [0.3, 0.3, 0.3, 0.5]      # zero width: 1e-6
        else:
            target = _boxes(rng, (2, 6), size=(0.1, 0.3))
    else:
        target = np.zeros((2, 6, 4), np.float32) if kind == 'edge' else \
            rng.normal(0.0, 1.0, (2, 6, 4)).astype(np.float32)
        if kind == 'edge':
            target[1] = [[2.0, -2.0, 3.0, -3.0]] * 6
    return {'prior': prior, 'var': var, 'target': target}


def _dist_feed(kind):
    if kind == 'edge':
        # ties across rows and columns, a padded all-zero gt row, a row
        # all below zero
        return {'d': np.array([[[0.5, 0.9, 0.9, 0.3, 0.0, 0.6],
                                [0.9, 0.5, 0.9, 0.3, 0.0, 0.6],
                                [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
                               [[-0.1, -0.2, -0.3, -0.4, -0.5, -0.6],
                                [0.7, 0.7, 0.7, 0.7, 0.7, 0.7],
                                [0.2, 0.46, 0.1, 0.45, 0.44, 0.8]]],
                              np.float32)}
    return {'d': np.random.RandomState(13).uniform(
        0.0, 1.0, (2, 3, 6)).astype(np.float32)}


def _match_feed(kind, m=3, n=6, seed=14):
    if kind == 'edge':
        return np.array([[-1, -1, -1, -1, -1, -1][:n],
                         [2, 0, -1, 2, 1, 0][:n]], np.int64)
    return np.random.RandomState(seed).randint(-1, m, (2, n)).astype(
        np.int64)


def _mine_feed(kind):
    if kind == 'edge':
        # ties in the loss; a row with no positive, a row all positive
        return {'loss': np.array([[0.5, 0.5, 0.5, 0.2, 0.2, 0.9, 0.0, 0.5],
                                  [0.1, 0.3, 0.3, 0.7, 0.7, 0.2, 0.3, 0.3],
                                  [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0,
                                   8.0]], np.float32),
                'match': np.array([[-1] * 8, [0, -1, -1, 1, -1, -1, -1, -1],
                                   [0, 1, 2, 0, 1, 2, 0, 1]], np.int64)}
    rng = np.random.RandomState(15)
    return {'loss': rng.uniform(0, 2, (3, 8)).astype(np.float32),
            'match': rng.randint(-1, 2, (3, 8)).astype(np.int64)}


def _nms_feed(kind):
    rng = np.random.RandomState(16)
    boxes = _boxes(rng, (2, 6), size=(0.2, 0.4))
    scores = rng.uniform(0.0, 1.0, (2, 3, 6)).astype(np.float32)
    if kind == 'edge':
        boxes[:, 1] = boxes[:, 0]                   # a duplicate
        boxes[:, 2] = boxes[:, 0] + 0.01            # a near duplicate
        scores[0, 1] = [0.8, 0.8, 0.8, 0.05, 0.8, 0.0]   # ties, low scores
        scores[1, 2] = 0.5                           # all tied
        scores[1, 1] = 0.0                           # nothing above 0.1
    return {'boxes': boxes, 'scores': scores}


def _ssd_feed(kind, b=2, n=8, m=2, c=3):
    rng = np.random.RandomState(17)
    prior = _boxes(rng, (n,), 0.0, 0.6, (0.2, 0.4))
    gt = prior[rng.randint(0, n, (b, m))] + \
        rng.uniform(-0.05, 0.05, (b, m, 4)).astype(np.float32)
    label = rng.randint(1, c, (b, m)).astype(np.int64)
    if kind == 'edge':
        gt[1, 1] = 0.0                               # a padded gt row
        gt[0, 0] = prior[3]                          # exactly a prior
    return {'loc': rng.normal(0, 1, (b, n, 4)).astype(np.float32),
            'conf': rng.normal(0, 1, (b, n, c)).astype(np.float32),
            'gtb': gt.astype(np.float32), 'gtl': label, 'prior': prior,
            'var': np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                           (n, 1))}


def _prior_feed(kind):
    rng = np.random.RandomState(18)
    if kind == 'edge':
        return {'feat': np.zeros((1, 2, 1, 1), np.float32),
                'img': np.zeros((1, 3, 7, 5), np.float32)}
    return {'feat': rng.normal(0, 1, (2, 3, 4, 5)).astype(np.float32),
            'img': rng.normal(0, 1, (2, 3, 32, 40)).astype(np.float32)}


# (build(L, v), feed(kind))
CASES = {
    'iou_similarity': (lambda L, v: L.iou_similarity(v['x'], v['y']),
                       _iou_feed),
    'iou_similarity_2d': (lambda L, v: L.iou_similarity(v['x'], v['y']),
                          lambda kind: _iou_feed(kind, False)),
    'box_coder_encode': (lambda L, v: L.box_coder(
        v['prior'], v['var'], v['target']),
        lambda kind: _coder_feed(kind, 'encode_center_size')),
    'box_coder_encode_no_var': (lambda L, v: L.box_coder(
        v['prior'], None, v['target']),
        lambda kind: _coder_feed(kind, 'encode_center_size')),
    'box_coder_aligned': (lambda L, v: L.box_coder(
        v['prior'], v['var'], v['target'], code_type='encode_aligned'),
        lambda kind: _coder_feed(kind, 'encode_aligned')),
    'box_coder_decode': (lambda L, v: L.box_coder(
        v['prior'], v['var'], v['target'], code_type='decode_center_size'),
        lambda kind: _coder_feed(kind, 'decode_center_size')),
    'prior_box': (lambda L, v: list(L.prior_box(
        v['feat'], v['img'], [8.0, 16.0], [16.0, 30.0], (1.0, 2.0),
        flip=True, clip=True)), _prior_feed),
    'prior_box_steps': (lambda L, v: list(L.prior_box(
        v['feat'], v['img'], [4.0], aspect_ratios=(1.0, 3.0, 0.5),
        variance=(0.2, 0.2, 0.1, 0.1), steps=(6.0, 7.0), offset=0.25)),
        _prior_feed),
    'bipartite_match': (lambda L, v: list(L.bipartite_match(v['d'])),
                        _dist_feed),
    'bipartite_match_per_prediction': (lambda L, v: list(
        L.bipartite_match(v['d'], match_type='per_prediction',
                          dist_threshold=0.45)), _dist_feed),
    'target_assign': (lambda L, v: list(L.target_assign(
        v['x'], v['m'], mismatch_value=0)), lambda kind: {
        'x': np.random.RandomState(19).normal(0, 1, (2, 3, 4)).astype(
            np.float32), 'm': _match_feed(kind)}),
    'target_assign_labels': (lambda L, v: list(L.target_assign(
        v['x'], v['m'], mismatch_value=5)), lambda kind: {
        'x': np.array([[[1], [2], [3]], [[4], [5], [6]]], np.int64),
        'm': _match_feed(kind)}),
    'mine_hard_examples': (lambda L, v: list(L.mine_hard_examples(
        v['loss'], v['match'], neg_pos_ratio=2.0)), _mine_feed),
    'multiclass_nms': (lambda L, v: L.multiclass_nms(
        v['boxes'], v['scores'], score_threshold=0.1, nms_top_k=4,
        keep_top_k=5, nms_threshold=0.3), _nms_feed),
    'multiclass_nms_wide': (lambda L, v: L.multiclass_nms(
        v['boxes'], v['scores'], background_label=1, keep_top_k=20,
        nms_threshold=0.5), _nms_feed),
    'pos_mask': (lambda L, v: L.detection.pos_mask(v['m']),
                 lambda kind: {'m': _match_feed(kind)}),
    'ssd_loss': (lambda L, v: L.ssd_loss(
        v['loc'], v['conf'], v['gtb'], v['gtl'], v['prior'], v['var']),
        _ssd_feed),
    'detection_output': (lambda L, v: L.detection_output(
        v['loc'], L.softmax(v['conf']), v['prior'], v['var'],
        keep_top_k=6, score_threshold=0.2), _ssd_feed),
}


@pytest.mark.parametrize('kind', ['random', 'edge'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_detection_op_parity(case, kind):
    """Each detection op (and ssd_loss and detection_output whole) loaded
    from the reference's program equals it, forward and gradient, fp32."""
    build, feed = CASES[case]
    check_parity(build, feed(kind))


# ------------------------------------------------ tests/test_detection.py
def _data(L, name, shape, dtype='float32'):
    return L.data(name=name, shape=list(shape), dtype=dtype,
                  append_batch_size=False)


def _same(ref, got, exact=()):
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.shape == g.shape
        if i in exact or r.dtype.kind in 'biu':
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


def test_iou_similarity_batched():
    gt = np.array([[[0., 0., 2., 2.], [1., 1., 3., 3.]]], dtype='float32')
    pr = np.array([[0., 0., 2., 2.], [2., 2., 4., 4.]], dtype='float32')
    ref, got, _, _, _ = run_both(lambda pkg: [pkg.layers.iou_similarity(
        _data(pkg.layers, 'x', (1, 2, 4)), _data(pkg.layers, 'y', (2, 4)))],
        {'x': gt, 'y': pr})
    _same(ref, got)
    np.testing.assert_allclose(got[0][0, 0], [1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(got[0][0, 1], [1 / 7, 1 / 7], rtol=1e-5)


DIST = np.array([[[0.5, 0.9, 0.3], [0.4, 0.8, 0.6]]], dtype='float32')


def test_bipartite_match_greedy():
    ref, got, _, _, _ = run_both(lambda pkg: list(pkg.layers.bipartite_match(
        _data(pkg.layers, 'd', (1, 2, 3)))), {'d': DIST})
    _same(ref, got)
    np.testing.assert_array_equal(got[0][0], [-1, 0, 1])
    np.testing.assert_allclose(got[1][0], [0.0, 0.9, 0.6], rtol=1e-6)


def test_bipartite_match_per_prediction():
    ref, got, _, _, _ = run_both(lambda pkg: [pkg.layers.bipartite_match(
        _data(pkg.layers, 'd', (1, 2, 3)), match_type='per_prediction',
        dist_threshold=0.45)[0]], {'d': DIST})
    _same(ref, got)
    np.testing.assert_array_equal(got[0][0], [0, 0, 1])


def test_target_assign():
    x_np = np.arange(12, dtype='float32').reshape(1, 3, 4)
    match_np = np.array([[1, -1, 0, 2]], dtype='int64')
    ref, got, _, _, _ = run_both(lambda pkg: list(pkg.layers.target_assign(
        _data(pkg.layers, 'x', (1, 3, 4)),
        _data(pkg.layers, 'm', (1, 4), 'int64'), mismatch_value=0)),
        {'x': x_np, 'm': match_np})
    _same(ref, got, exact=(0, 1))
    np.testing.assert_array_equal(got[0][0, 0], x_np[0, 1])
    np.testing.assert_array_equal(got[1][0].ravel(), [1, 0, 1, 1])


def test_mine_hard_examples():
    loss_np = np.array([[0.1, 0.9, 0.3, 0.7, 0.5]], dtype='float32')
    match_np = np.array([[0, -1, -1, -1, -1]], dtype='int64')
    ref, got, _, _, _ = run_both(lambda pkg: list(
        pkg.layers.mine_hard_examples(
            _data(pkg.layers, 'l', (1, 5)),
            _data(pkg.layers, 'm', (1, 5), 'int64'), neg_pos_ratio=2.0)),
        {'l': loss_np, 'm': match_np})
    _same(ref, got)
    np.testing.assert_array_equal(got[0][0], [0, -1, -2, -1, -2])
    np.testing.assert_array_equal(got[1][0], [0, 1, 0, 1, 0])


def test_multiclass_nms_suppresses_overlaps():
    boxes_np = np.array([[[0, 0, 2, 2], [0, 0, 2.1, 2.1], [5, 5, 7, 7]]],
                        dtype='float32')
    scores_np = np.zeros((1, 2, 3), dtype='float32')
    scores_np[0, 1] = [0.9, 0.8, 0.7]
    ref, got, _, _, _ = run_both(lambda pkg: [pkg.layers.multiclass_nms(
        _data(pkg.layers, 'b', (1, 3, 4)), _data(pkg.layers, 's', (1, 2, 3)),
        score_threshold=0.1, nms_threshold=0.5, keep_top_k=4)],
        {'b': boxes_np, 's': scores_np})
    _same(ref, got, exact=(0,))
    kept = got[0][0][got[0][0][:, 0] >= 0]
    assert len(kept) == 2
    np.testing.assert_array_equal(kept[1, 2:], [5, 5, 7, 7])


def test_box_coder_encode_decode_roundtrip():
    """encode_center_size of a gt box against two priors, then the decode
    of the encoding back: the gt box, in both packages alike."""
    priors_np = np.array([[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.8]],
                         dtype='float32')
    var_np = np.tile(np.array([0.1, 0.1, 0.2, 0.2], dtype='float32'),
                     (2, 1))
    gt_np = np.array([[0.15, 0.12, 0.48, 0.55]], dtype='float32')

    def build(pkg):
        L = pkg.layers
        p, v = _data(L, 'p', (2, 4)), _data(L, 'v', (2, 4))
        enc = L.box_coder(p, v, _data(L, 't', (1, 4)),
                          code_type='encode_center_size')
        return [enc, L.box_coder(p, v, enc, code_type='decode_center_size')]
    ref, got, _, _, _ = run_both(build, {'p': priors_np, 'v': var_np,
                                         't': gt_np})
    _same(ref, got)
    assert got[0].shape == (1, 2, 4)
    np.testing.assert_allclose(got[1][0], np.repeat(gt_np, 2, 0),
                               atol=1e-6)


def test_ssd_loss_end_to_end_trains():
    """ssd_loss under a trainable head on fed features, 12 Adam(0.05)
    steps in both packages: the losses rtol 1e-5, and falling."""
    B, N, M, C = 2, 8, 2, 3
    rng = np.random.RandomState(1)
    priors_np = rng.uniform(0.0, 0.8, (N, 4)).astype('float32')
    priors_np[:, 2:] = priors_np[:, :2] + 0.2
    feed = {'feat': rng.randn(B, N, 8).astype('float32'),
            'gtb': priors_np[:M].copy()[None].repeat(B, 0),
            'gtl': np.array([[1, 2], [2, 1]], dtype='int64'),
            'pb': priors_np}

    def build(pkg):
        L = pkg.layers
        gtb = L.data(name='gtb', shape=[M, 4], dtype='float32')
        gtl = L.data(name='gtl', shape=[M], dtype='int64')
        pb = _data(L, 'pb', (N, 4))
        feat = L.data(name='feat', shape=[N, 8], dtype='float32')
        loc_pred = L.fc(input=feat, size=4, num_flatten_dims=2)
        conf_pred = L.fc(input=feat, size=C, num_flatten_dims=2)
        return [L.mean(L.ssd_loss(loc_pred, conf_pred, gtb, gtl, pb))]
    trace = []
    run_both(build, feed, steps=12, trace=trace,
             optimizer=lambda pkg: pkg.optimizer.Adam(learning_rate=0.05))
    ref = [float(r[0].reshape(-1)[0]) for r, _ in trace]
    got = [float(g[0].reshape(-1)[0]) for _, g in trace]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert got[-1] < got[0]


def test_multi_box_head_shapes():
    def build(pkg):
        L = pkg.layers
        img = L.data(name='img', shape=[3, 32, 32], dtype='float32')
        f1 = L.conv2d(input=img, num_filters=8, filter_size=3, stride=4,
                      padding=1)
        f2 = L.conv2d(input=f1, num_filters=8, filter_size=3, stride=2,
                      padding=1)
        return list(L.multi_box_head(
            inputs=[f1, f2], image=img, num_classes=4,
            min_sizes=[8.0, 16.0], aspect_ratios=[[1.0], [1.0, 2.0]],
            flip=True))
    img = np.random.RandomState(0).uniform(-1, 1, (2, 3, 32, 32)).astype('f')
    ref, got, _, _, _ = run_both(build, {'img': img})
    _same(ref, got)
    n_priors = got[2].shape[0]
    assert n_priors == 8 * 8 + 4 * 4 * 3
    assert got[0].shape == (2, n_priors, 4) and got[1].shape == \
        (2, n_priors, 4) and got[3].shape == (n_priors, 4)


def _ssd(pkg):
    return importlib.import_module(pkg.__name__ + '.models.ssd')


def _ssd_train_feed(b=2, max_gt=3, size=64, seed=2):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0.1, 0.5, (b, max_gt, 4)).astype('float32')
    gt[:, :, 2:] = gt[:, :, :2] + 0.3
    return {'image': rng.rand(b, 3, size, size).astype('float32'),
            'gt_box': gt,
            'gt_label': rng.randint(1, 4, (b, max_gt)).astype('int64')}


def _ssd_train_both(steps, max_gt=3, optimizer=None):
    trace = []
    res = run_both(lambda pkg: [_ssd(pkg).ssd_train(
        num_classes=4, image_shape=(3, 64, 64), max_gt=max_gt)[0]],
        _ssd_train_feed(max_gt=max_gt), steps=steps, trace=trace,
        optimizer=optimizer or (
            lambda pkg: pkg.optimizer.Adam(learning_rate=1e-3)))
    ref = [float(r[0].reshape(-1)[0]) for r, _ in trace]
    got = [float(g[0].reshape(-1)[0]) for _, g in trace]
    return ref, got, res


def test_ssd_model_trains_and_infers():
    """tests/test_detection.py's 6 Adam steps of ssd_train (3 x 64 x 64,
    4 classes, 3 gt boxes): the port's losses are the reference's (rtol
    1e-5), finite and falling."""
    ref, got, _ = _ssd_train_both(6)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert got[-1] < got[0]


def test_ssd_detection_output_shape():
    ref, got, _, _, _ = run_both(lambda pkg: [_ssd(pkg).ssd_infer(
        num_classes=4, image_shape=(3, 64, 64), keep_top_k=8)[0]],
        {'image': np.random.RandomState(3).rand(2, 3, 64, 64).astype('f')})
    assert got[0].shape == (2, 8, 6)
    np.testing.assert_array_equal(got[0][..., 0], ref[0][..., 0])


# ------------------------------------------------------------ models/ssd
def test_ssd_train_three_steps_match_the_reference():
    """ssd_train at 3 x 64 x 64, 4 classes, max_gt 8 (the model's
    default): 3 Adam(1e-3) steps from the reference startup's weights,
    the losses rtol 1e-5. Then one SGD(1.0) step, whose change of each
    parameter is its gradient (Adam divides each element's step by its
    own gradient's scale, which no tolerance on the change can hold):
    within 1e-4 of the reference's largest change, plus 4 float32 ulps
    of the parameter (the coarsest map's block and head get no gradient
    in either package: no gt box matches its priors)."""
    ref, got, _ = _ssd_train_both(3, max_gt=8)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    _, _, (_, _, jscope, pscope, w0) = _ssd_train_both(
        1, max_gt=8, optimizer=lambda pkg: pkg.optimizer.SGD(1.0))
    params = [p.name for p in fluid.default_main_program().all_parameters()]
    assert len(params) == 27
    for n in params:
        want = np.asarray(jscope.find(n), 'float64') - w0[n]
        moved = pscope.numpy(n).astype('float64') - w0[n]
        atol = 1e-4 * np.abs(want).max() + \
            4 * 2.0 ** -23 * np.abs(w0[n]).max()
        np.testing.assert_allclose(moved, want, rtol=0, atol=atol,
                                   err_msg=n)


def test_ssd_infer_detections_match_the_reference():
    """ssd_infer (keep_top_k 16) on the reference startup's weights, batch
    4: the labels exact, scores and boxes within 1e-5."""
    img = np.random.RandomState(4).rand(4, 3, 64, 64).astype('float32')
    ref, got, _, _, _ = run_both(lambda pkg: [_ssd(pkg).ssd_infer(
        num_classes=4, image_shape=(3, 64, 64))[0]], {'image': img})
    assert got[0].shape == (4, 16, 6)
    assert (got[0][..., 0] >= 0).sum() > 0
    np.testing.assert_array_equal(got[0][..., 0], ref[0][..., 0])
    np.testing.assert_allclose(got[0][..., 1:], ref[0][..., 1:], rtol=0,
                               atol=1e-5)
