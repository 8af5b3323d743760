"""Reader creators (reference: paddle_tpu reader/creator.py;
python/paddle/v2/reader/creator.py np_array / text_file / recordio).
``recordio`` needs the native reader, not ported (ROADMAP Queue 1 item
11)."""

__all__ = ['np_array', 'text_file', 'recordio']


def np_array(x):
    """Yield rows of an ndarray."""
    import numpy as np
    arr = np.asarray(x)

    def reader():
        for row in arr:
            yield row
    return reader


def text_file(path):
    """Yield lines of a text file (newline stripped)."""
    def reader():
        with open(path, 'r') as f:
            for line in f:
                yield line.rstrip('\n')
    return reader


def recordio(paths, buf_size=100):
    """Not ported: the native recordio reader (ROADMAP Queue 1 item 11)."""
    raise NotImplementedError(
        'reader.creator.recordio needs the native recordio reader, not '
        'ported to paddle_tpu_torch (ROADMAP Queue 1 item 11)')
