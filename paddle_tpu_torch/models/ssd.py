"""SSD object detector (reference: paddle_tpu models/ssd.py, the SSD
config built on fluid/layers/detection.py: MobileNet-SSD style, a shrunk
feature pyramid).

The backbone is five conv + batch_norm blocks (batch_norm on
csrc/batch_norm.cu on the card); the heads come from
layers.multi_box_head; training uses layers.ssd_loss (bipartite match and
hard-negative mining); inference uses layers.detection_output (decode and
multiclass NMS). Every op is static-shape, so a step is captured.
"""

from .. import layers


def _conv_block(x, filters, stride):
    c = layers.conv2d(input=x, num_filters=filters, filter_size=3,
                      stride=stride, padding=1, act=None, bias_attr=False)
    return layers.batch_norm(input=c, act='relu')


def ssd_net(image, num_classes=21, image_shape=(3, 128, 128)):
    """Builds the backbone + multibox head. Returns
    (locs [B,N,4], confs [B,N,C], prior_boxes [N,4], prior_vars [N,4])."""
    f = _conv_block(image, 16, 2)      # /2
    f = _conv_block(f, 32, 2)          # /4
    f1 = _conv_block(f, 64, 2)         # /8
    f2 = _conv_block(f1, 128, 2)       # /16
    f3 = _conv_block(f2, 128, 2)       # /32
    s = image_shape[1]
    locs, confs, boxes, vars_ = layers.multi_box_head(
        inputs=[f1, f2, f3], image=image, num_classes=num_classes,
        min_sizes=[s * 0.1, s * 0.3, s * 0.6],
        max_sizes=[s * 0.3, s * 0.6, s * 0.9],
        aspect_ratios=[[1.0, 2.0], [1.0, 2.0], [1.0, 2.0]],
        flip=True, clip=True, kernel_size=3, pad=1)
    return locs, confs, boxes, vars_


def ssd_train(num_classes=21, image_shape=(3, 128, 128), max_gt=8):
    """Training graph: feeds image, gt_box [B,M,4], gt_label [B,M].
    Returns (avg_loss, feeds)."""
    image = layers.data(name='image', shape=list(image_shape),
                        dtype='float32')
    gt_box = layers.data(name='gt_box', shape=[max_gt, 4],
                         dtype='float32')
    gt_label = layers.data(name='gt_label', shape=[max_gt], dtype='int64')
    locs, confs, boxes, vars_ = ssd_net(image, num_classes, image_shape)
    loss = layers.ssd_loss(locs, confs, gt_box, gt_label, boxes, vars_)
    avg = layers.mean(loss)
    return avg, ['image', 'gt_box', 'gt_label']


def ssd_infer(num_classes=21, image_shape=(3, 128, 128), keep_top_k=16):
    """Inference graph: image -> [B, keep_top_k, 6] detections."""
    image = layers.data(name='image', shape=list(image_shape),
                        dtype='float32')
    locs, confs, boxes, vars_ = ssd_net(image, num_classes, image_shape)
    probs = layers.softmax(confs)
    out = layers.detection_output(locs, probs, boxes, vars_,
                                  keep_top_k=keep_top_k)
    return out, ['image']
