"""The vision model zoo (port of ``paddle_tpu/vision/models/``), in the
reference's export order: ``resnext.py``'s ``resnext50_32x4d`` and
``resnext101_32x4d`` replace ``resnet.py``'s."""
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2, resnext50_32x4d, resnext101_32x4d,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .vit import VisionTransformer, vit_b_16, vit_l_16  # noqa: F401
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201, densenet264,
)
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0,
)
from .resnext import (  # noqa: F401
    ResNeXt, resnext50_32x4d, resnext101_32x4d, resnext152_32x4d,
)
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .yolov3 import YOLOv3, yolov3_darknet53, YOLOv3Postprocess  # noqa: F401
