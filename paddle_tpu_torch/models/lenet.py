"""LeNet-5 on MNIST, the reference book's ``recognize_digits`` conv
model: the port's copy of ``paddle_tpu/models/lenet.py`` (the same
program, op for op)."""
from __future__ import annotations

from .. import layers


def lenet(images, label=None, class_num: int = 10):
    """Build LeNet forward (+ loss/acc when `label` given).

    images: [-1, 1, 28, 28] float32; label: [-1, 1] int64.
    Returns dict with 'prediction' and, with label, 'loss'/'acc'.
    """
    conv1 = layers.conv2d(images, num_filters=20, filter_size=5, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2, pool_type="max")
    conv2 = layers.conv2d(pool1, num_filters=50, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2, pool_type="max")
    hidden = layers.fc(pool2, size=500, act="relu")
    prediction = layers.fc(hidden, size=class_num, act="softmax")
    out = {"prediction": prediction}
    if label is not None:
        loss = layers.cross_entropy(prediction, label)
        out["loss"] = layers.mean(loss)
        out["acc"] = layers.accuracy(prediction, label)
    return out


def build_mnist_train(batch_size=None):
    """Declare feed vars + LeNet + loss in the current default program.

    Returns (feed_names, outputs-dict).
    """
    bshape = [-1 if batch_size is None else batch_size]
    images = layers.data("images", bshape + [1, 28, 28],
                         append_batch_size=False)
    label = layers.data("label", bshape + [1], dtype="int64",
                        append_batch_size=False)
    outs = lenet(images, label)
    return ["images", "label"], outs
