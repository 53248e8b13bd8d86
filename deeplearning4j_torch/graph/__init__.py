"""Graph embeddings (reference deeplearning4j-graph): the port of
`deeplearning4j_tpu/graph`."""
from .core import Graph, RandomWalkIterator
from .deepwalk import DeepWalk
from .node2vec import Node2Vec, Node2VecWalker
