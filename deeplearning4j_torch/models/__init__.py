"""Model zoo (reference deeplearning4j-zoo): the models this slice serves."""
from .zoo import AlexNet, LeNet, ZooModel
