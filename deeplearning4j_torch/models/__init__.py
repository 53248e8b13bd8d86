"""Model zoo (reference deeplearning4j-zoo): the models the port runs."""
from .zoo import AlexNet, GoogLeNet, LeNet, ZooModel
