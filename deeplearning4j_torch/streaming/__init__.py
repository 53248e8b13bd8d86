"""Streaming: NDArray pub/sub + model-serving routes (reference
dl4j-streaming: Kafka NDArrayPublisher/NDArrayConsumer + Camel
DL4jServeRouteBuilder). Port of `deeplearning4j_tpu/streaming/`."""
from .ndarray_stream import (Broker, HttpBrokerClient, InProcessBroker,
                             NDArrayConsumer, NDArrayPublisher,
                             NDArrayStreamServer, NDArrayTopic, ServeRoute,
                             get_default_broker, set_default_broker)
