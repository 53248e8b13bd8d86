"""Model zoo (reference deeplearning4j-zoo): the models the port runs."""
from .labels import ImageNetLabels
from .zoo import (AlexNet, FaceNetNN4Small2, GoogLeNet, InceptionResNetV1,
                  LeNet, ResNet50, SimpleCNN, TextGenerationLSTM, VGG16, VGG19,
                  ZooModel, ZooType, model_selector)
