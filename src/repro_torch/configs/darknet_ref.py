"""The paper's own use-case: a Darknet-style CNN (the port's copy of
``repro/configs/darknet_ref.py``, cfg strings unchanged).

A darknet-19-flavoured classifier (conv+BN+leaky, maxpool pyramid, global
avgpool head) plus a small encoder-decoder net exercising the
[deconvolutional] path the paper explicitly supports.  These are the
configs the port's tests and chip_smoke.py run.
"""

# Reduced-resolution darknet-19-style classifier (28x28x3 -> 10 classes).
DARKNET_SMALL_CFG = """
[net]
height=28
width=28
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-1
activation=linear

[avgpool]

[connected]
output=10
activation=linear

[softmax]
"""

# ImageNet-scale darknet-19 trunk (224x224) — used by the full benchmark.
DARKNET19_CFG = """
[net]
height=224
width=224
channels=3

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=64
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=64
size=1
stride=1
pad=0
activation=leaky

[convolutional]
batch_normalize=1
filters=128
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=128
size=1
stride=1
pad=0
activation=leaky

[convolutional]
batch_normalize=1
filters=256
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=256
size=1
stride=1
pad=0
activation=leaky

[convolutional]
batch_normalize=1
filters=512
size=3
stride=1
pad=1
activation=leaky

[avgpool]

[connected]
output=1000
activation=linear

[softmax]
"""

# Encoder-decoder exercising [deconvolutional] + [route] + [upsample].
SEGNET_SMALL_CFG = """
[net]
height=32
width=32
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[deconvolutional]
filters=16
size=2
stride=2
pad=0
activation=leaky

[route]
layers=0,2

[upsample]
stride=2

[convolutional]
filters=4
size=1
stride=1
pad=0
activation=linear
"""
