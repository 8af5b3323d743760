"""Shape buckets (reference: paddle_tpu serving/buckets.py)."""


def pow2_ladder(hi, lo=1):
    """Powers of two from `lo` up through `hi`; `hi` itself caps the
    ladder when it is not a power of two (the top rung must admit a
    full batch)."""
    hi, lo = int(hi), int(lo)
    if lo < 1 or hi < lo:
        raise ValueError('pow2_ladder: need 1 <= lo <= hi, got '
                         'lo=%d hi=%d' % (lo, hi))
    rungs = []
    r = 1
    while r < lo:
        r *= 2
    while r < hi:
        rungs.append(r)
        r *= 2
    rungs.append(hi)
    return rungs
