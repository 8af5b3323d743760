"""How far rounding alone moves the deep CNN tests' numbers: for each
build of tests/test_torch_{mobilenet,resnext,cnn_deep,googlenet}.py,
3 Momentum steps (dropout at 0) of

  port vs reference   the port against the JAX package (what the tests hold)
  port vs nudged      the port against itself, the images scaled by 1 + 2^-23
  ref vs nudged       the JAX package against itself, the same nudge
  port vs native      the port against itself with torch's CPU convolutions
                      on its native kernels instead of oneDNN (sums in
                      another order, nothing else changed)

each printed as the three losses' relative gaps, the first step's
gradients (test_torch_cnn_models.grad_gap: the largest relative norm of
a parameter's gap, its norm floored at 1e-3 of the largest parameter's;
grad_norm_gap: over all parameters together) and the parameters after
the third step (largest absolute gap). A gap that a one-ulp nudge or a
change of summation order reproduces is the net's conditioning, not a
fault of the port.

    JAX_PLATFORMS=cpu python tests/torch_cnn_conditioning.py \\
        [--amp bf16] [--lr 0.01] [net ...]

(nets: mobilenet_nchw mobilenet_nhwc se_resnext vgg_bn_drop googlenet;
the JAX package's batch norm on its Pallas kernel in interpret mode, as
the tests run it)."""

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ['PADDLE_TPU_BN_PALLAS'] = '1'
os.environ['PADDLE_TPU_PALLAS_INTERPRET'] = '1'

import torch  # noqa: E402

import test_torch_cnn_models as T  # noqa: E402
from test_torch_cnn_deep import VGG  # noqa: E402
from test_torch_googlenet import GOOGLENET  # noqa: E402
from test_torch_mobilenet import CASES as MOBILE  # noqa: E402
from test_torch_resnext import CASE as RESNEXT  # noqa: E402

NETS = {c[0]: c for c in MOBILE + [VGG, GOOGLENET, RESNEXT]}


def gaps(a, b):
    """(loss gaps, grad_gap, grad_norm_gap, parameter gap) of two runs
    (losses, first gradients, parameters after the last step)."""
    pairs = {n: (b[1][n], a[1][n]) for n in b[1]}
    return ([abs(x - y) / abs(y) for x, y in zip(a[0], b[0])],
            T.grad_gap(pairs), T.grad_norm_gap(pairs),
            max(float(np.abs(a[2][n] - b[2][n]).max()) for n in b[2]))


def witness(key, amp, lr):
    T.LR = lr
    case = NETS[key]
    build = T.small_build(case, amp)
    feed = T.case_feed(case)
    nudged = dict(feed, image=feed['image'] * np.float32(1 + 2.0 ** -23))

    def ref(f):
        losses, grads, _, scope, arrays, params = T.reference_run(build, f)
        return (losses, grads, {n: np.asarray(scope.find(n), 'float64')
                                for n in params}), arrays

    def port(f, arrays, mkldnn=True):
        with torch.backends.mkldnn.flags(enabled=mkldnn):
            losses, grads, _, scope = T.port_run(build, arrays, f)
        return losses, grads, {n: scope.numpy(n).astype('float64')
                               for n in grads}
    r, arrays = ref(feed)
    p = port(feed, arrays)
    rows = [('port vs reference', p, r),
            ('port vs nudged', p, port(nudged, arrays)),
            ('ref vs nudged', r, ref(nudged)[0]),
            ('port vs native', p, port(feed, arrays, mkldnn=False))]
    print('%s %s, LR %g: port losses %s' % (key, amp or 'fp32', lr,
                                            ['%.6f' % v for v in p[0]]))
    for name, a, b in rows:
        loss, g, norm, w = gaps(a, b)
        print('  %-18s losses %s  grad_gap %.3g  grad_norm_gap %.3g  '
              'parameters %.3g' % (name, ['%.2g' % v for v in loss], g,
                                   norm, w), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--amp', choices=['bf16'], default=None)
    ap.add_argument('--lr', type=float, default=T.LR)
    ap.add_argument('nets', nargs='*', default=sorted(NETS))
    args = ap.parse_args()
    for key in args.nets:
        witness(key, args.amp, args.lr)


if __name__ == '__main__':
    main()
