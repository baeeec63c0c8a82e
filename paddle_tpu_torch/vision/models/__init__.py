"""``paddle.vision.models`` of the port: every model family of the
reference — LeNet, the ResNets, AlexNet, VGG, SqueezeNet, MobileNetV1,
V2 and V3, ShuffleNetV2, GoogLeNet, InceptionV3 and DenseNet."""
from .lenet import LeNet
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .mobilenet import MobileNetV2, mobilenet_v2
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .alexnet import AlexNet, alexnet
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                           shufflenet_v2_x0_5, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)

__all__ = ["LeNet", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2", "MobileNetV2",
           "mobilenet_v2", "MobileNetV1", "mobilenet_v1", "MobileNetV3Large",
           "MobileNetV3Small", "mobilenet_v3_large", "mobilenet_v3_small",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "AlexNet", "alexnet",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "DenseNet",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "densenet264", "GoogLeNet", "googlenet", "InceptionV3",
           "inception_v3", "ShuffleNetV2", "shufflenet_v2_swish",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
           "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0"]
