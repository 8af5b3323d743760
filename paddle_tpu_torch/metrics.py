"""Host-side streaming metrics (reference: python/paddle/fluid/metrics.py
in later versions; Accuracy/ChunkEvaluator live in evaluator.py)."""

import numpy as np

__all__ = ['MetricBase', 'CompositeMetric', 'Accuracy', 'Auc',
           'EditDistance', 'Precision', 'Recall', 'DetectionMAP']


class MetricBase(object):
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        return self.value / self.weight if self.weight else 0.0


class Precision(MetricBase):
    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1) > 0.5
        labels = np.asarray(labels).reshape(-1) > 0.5
        self.tp += int(np.sum(preds & labels))
        self.fp += int(np.sum(preds & ~labels))

    def eval(self):
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1) > 0.5
        labels = np.asarray(labels).reshape(-1) > 0.5
        self.tp += int(np.sum(preds & labels))
        self.fn += int(np.sum(~preds & labels))

    def eval(self):
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    def update(self, distances, seq_num=None):
        d = np.asarray(distances).reshape(-1)
        self.total += float(d.sum())
        self.count += int(seq_num if seq_num is not None else d.size)

    def eval(self):
        return self.total / self.count if self.count else 0.0


class Auc(MetricBase):
    """Streaming AUC with threshold buckets (reference auc_op.cc)."""

    def __init__(self, name=None, num_thresholds=4095):
        super(Auc, self).__init__(name)
        self._num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1)
        self._stat_neg = np.zeros(self._num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        idx = np.clip((preds * self._num_thresholds).astype(int), 0,
                      self._num_thresholds)
        for i, lab in zip(idx, labels):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def eval(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0


class DetectionMAP(MetricBase):
    """VOC-style mean average precision over detections.

    Reference: paddle/fluid/operators/detection_map_op.h (CalcMAP at
    :387-447, greedy IoU matching above it). AP needs per-class sorting
    and data-dependent matching and runs once an evaluation, so it lives
    on the host over fetched detections, outside the captured step.

    update() takes, per image:
      detections: [M, 6] rows (label, score, xmin, ymin, xmax, ymax)
      gt_boxes:   [N, 5] rows (label, xmin, ymin, xmax, ymax) or
                  [N, 6] with a trailing is_difficult flag.
    eval() returns mAP in [0, 100].
    """

    def __init__(self, overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version='integral', name=None):
        super(DetectionMAP, self).__init__(name)
        if ap_version not in ('integral', '11point'):
            raise ValueError("ap_version must be 'integral' or '11point'")
        self._thresh = overlap_threshold
        self._eval_difficult = evaluate_difficult
        self._ap_version = ap_version
        self.reset()

    def reset(self):
        self._pos_count = {}   # class -> #gt boxes
        self._scored = {}      # class -> list of (score, is_tp)

    @staticmethod
    def _iou(box, boxes):
        ix1 = np.maximum(box[0], boxes[:, 0])
        iy1 = np.maximum(box[1], boxes[:, 1])
        ix2 = np.minimum(box[2], boxes[:, 2])
        iy2 = np.minimum(box[3], boxes[:, 3])
        iw = np.maximum(ix2 - ix1, 0.0)
        ih = np.maximum(iy2 - iy1, 0.0)
        inter = iw * ih
        a1 = (box[2] - box[0]) * (box[3] - box[1])
        a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        union = a1 + a2 - inter
        return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)

    def update(self, detections, gt_boxes):
        detections = np.asarray(detections, dtype='float64').reshape(-1, 6)
        gt = np.asarray(gt_boxes, dtype='float64')
        gt = gt.reshape(-1, gt.shape[-1]) if gt.size else gt.reshape(0, 5)
        difficult = gt[:, 5].astype(bool) if gt.shape[-1] >= 6 \
            else np.zeros(len(gt), bool)
        for cls in np.unique(gt[:, 0]).astype(int) if len(gt) else []:
            sel = (gt[:, 0] == cls) & (self._eval_difficult | ~difficult)
            self._pos_count[cls] = self._pos_count.get(cls, 0) + \
                int(sel.sum())
        for cls in (np.unique(detections[:, 0]).astype(int)
                    if len(detections) else []):
            dets = detections[detections[:, 0] == cls]
            dets = dets[np.argsort(-dets[:, 1])]  # score desc
            cls_gt = gt[gt[:, 0] == cls][:, 1:5] if len(gt) else \
                np.zeros((0, 4))
            matched = np.zeros(len(cls_gt), bool)
            bucket = self._scored.setdefault(cls, [])
            for det in dets:
                if len(cls_gt):
                    ious = self._iou(det[2:6], cls_gt)
                    best = int(ious.argmax())
                    if ious[best] >= self._thresh and not matched[best]:
                        matched[best] = True
                        bucket.append((float(det[1]), 1))
                        continue
                bucket.append((float(det[1]), 0))

    def eval(self):
        m_ap, count = 0.0, 0
        for cls, npos in self._pos_count.items():
            if npos == 0 or cls not in self._scored:
                continue
            pairs = sorted(self._scored[cls], key=lambda p: -p[0])
            tps = np.cumsum([tp for _, tp in pairs])
            fps = np.cumsum([1 - tp for _, tp in pairs])
            precision = tps / np.maximum(tps + fps, 1e-10)
            recall = tps / float(npos)
            if self._ap_version == '11point':
                ap = 0.0
                for t in np.arange(0.0, 1.1, 0.1):
                    p = precision[recall >= t]
                    ap += (p.max() if len(p) else 0.0) / 11.0
            else:  # natural integral (detection_map_op.h:430-439)
                ap, prev_r = 0.0, 0.0
                for p, r in zip(precision, recall):
                    if abs(r - prev_r) > 1e-6:
                        ap += p * abs(r - prev_r)
                    prev_r = r
            m_ap += ap
            count += 1
        return (m_ap / count) * 100.0 if count else 0.0
