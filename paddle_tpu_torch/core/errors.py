"""Error checking (reference: paddle/fluid/platform/enforce.h
PADDLE_ENFORCE / EnforceNotMet).

enforce() raises EnforceError at graph-build time (shape inference, attr
checks), before anything runs on the device.
"""

__all__ = ['EnforceError', 'enforce', 'enforce_eq', 'enforce_shape_match']


class EnforceError(RuntimeError):
    """Raised when a framework invariant is violated (EnforceNotMet)."""


def enforce(condition, message, *fmt_args):
    if not condition:
        raise EnforceError(message % fmt_args if fmt_args else message)


def enforce_eq(a, b, message=None):
    if a != b:
        raise EnforceError(message or 'enforce_eq failed: %r != %r' % (a, b))


def enforce_shape_match(shape_a, shape_b, message=None):
    """None dims (unknown batch) match anything."""
    ok = len(shape_a) == len(shape_b) and all(
        x is None or y is None or x == y or x == -1 or y == -1
        for x, y in zip(shape_a, shape_b))
    if not ok:
        raise EnforceError(
            message or 'shape mismatch: %s vs %s' % (shape_a, shape_b))
