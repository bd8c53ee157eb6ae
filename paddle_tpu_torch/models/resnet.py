"""ResNet for ImageNet (He et al. 2016): the port's copy of
``paddle_tpu/models/resnet.py`` (the same program, op for op): NCHW,
depths 18-152, bottleneck blocks from 50 layers on, batch norm with
persistable moving statistics updated in place by each training step,
``is_test`` for the serving program."""
from __future__ import annotations

from .. import layers

_DEPTH_CFG = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def _conv_bn(x, num_filters, filter_size, stride=1, act=None, is_test=False):
    conv = layers.conv2d(x, num_filters=num_filters, filter_size=filter_size,
                         stride=stride, padding=(filter_size - 1) // 2,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def _shortcut(x, ch_out, stride, is_test):
    ch_in = x.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, is_test=is_test)
    return x


def _basic_block(x, num_filters, stride, is_test):
    conv0 = _conv_bn(x, num_filters, 3, stride, act="relu", is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, 1, is_test=is_test)
    short = _shortcut(x, num_filters, stride, is_test)
    return layers.relu(layers.elementwise_add(short, conv1))


def _bottleneck(x, num_filters, stride, is_test):
    conv0 = _conv_bn(x, num_filters, 1, act="relu", is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, stride, act="relu",
                     is_test=is_test)
    conv2 = _conv_bn(conv1, num_filters * 4, 1, is_test=is_test)
    short = _shortcut(x, num_filters * 4, stride, is_test)
    return layers.relu(layers.elementwise_add(short, conv2))


def resnet(images, label=None, depth: int = 50, class_num: int = 1000,
           is_test: bool = False):
    """images: [-1, 3, H, W]; label: [-1, 1] int64."""
    stages, bottleneck = _DEPTH_CFG[depth]
    x = _conv_bn(images, 64, 7, stride=2, act="relu", is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    block = _bottleneck if bottleneck else _basic_block
    num_filters = [64, 128, 256, 512]
    for stage, count in enumerate(stages):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            x = block(x, num_filters[stage], stride, is_test)
    pool = layers.adaptive_pool2d(x, pool_size=1, pool_type="avg")
    logits = layers.fc(pool, size=class_num)
    out = {"logits": logits}
    if label is not None:
        loss = layers.softmax_with_cross_entropy(logits, label)
        out["loss"] = layers.mean(loss)
        out["acc"] = layers.accuracy(layers.softmax(logits), label)
    return out


def build_resnet_train(batch_size=None, depth=50, image_size=224,
                       class_num=1000):
    b = -1 if batch_size is None else batch_size
    images = layers.data("images", [b, 3, image_size, image_size],
                         append_batch_size=False)
    label = layers.data("label", [b, 1], dtype="int64",
                        append_batch_size=False)
    outs = resnet(images, label, depth=depth, class_num=class_num)
    return ["images", "label"], outs
