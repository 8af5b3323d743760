"""Device places (reference: paddle/fluid/platform/place.h CPUPlace/CUDAPlace).

``CUDAPlace(n)`` is ``cuda:n`` and ``CPUPlace()`` is ``cpu``. There is no
fallback: resolving a CUDAPlace on a machine without that CUDA device
raises, so a run that asked for the card never silently lands on the
host.
"""

import torch


class Place(object):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return '%s(%d)' % (type(self).__name__, self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def device(self):
        raise NotImplementedError


class CPUPlace(Place):
    def device(self):
        return torch.device('cpu')


class CUDAPlace(Place):
    def device(self):
        """torch.device('cuda:n'); raises when that device does not
        exist."""
        if not torch.cuda.is_available():
            raise RuntimeError(
                '%r: no CUDA device is available. Pass CPUPlace() to run '
                'on the host.' % (self,))
        count = torch.cuda.device_count()
        if self.device_id >= count:
            raise RuntimeError('%r: only %d CUDA device(s) present'
                               % (self, count))
        return torch.device('cuda', self.device_id)
