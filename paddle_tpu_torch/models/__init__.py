"""Model builders: the Transformer (training graph and the decode LM's
pieces, models/transformer.py), the Switch-MoE LM (models/moe.py), the
ResNet family (models/resnet.py), the embedding models Wide&Deep CTR
(models/wide_deep.py), the recommender (models/recommender.py) and
word2vec (models/word2vec.py), fit_a_line (models/linear.py), the
sentiment and tagging sequence models (models/seq_models.py), semantic
role labeling (models/srl.py), the RNN-search seq2seq
(models/rnn_search.py), the SSD detector (models/ssd.py) and the image
classifiers of the conv path: MobileNet v1 (models/mobilenet.py),
SE-ResNeXt (models/resnext.py), VGG (models/vgg.py), AlexNet
(models/alexnet.py), GoogLeNet (models/googlenet.py) and the MNIST nets
(models/lenet.py)."""

from . import lenet  # noqa: F401
from . import vgg  # noqa: F401
from . import alexnet  # noqa: F401
from . import googlenet  # noqa: F401
from . import mobilenet  # noqa: F401
from . import resnext  # noqa: F401
