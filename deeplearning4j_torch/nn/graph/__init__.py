"""ComputationGraph: DAG networks (reference deeplearning4j-nn nn/graph)."""
from .fusion import (FusionGroup, find_sibling_conv_groups, fuse_graph,
                     fuse_params, fuse_sibling_convs, unfuse_params)
from .graph import ComputationGraph
from .vertices import (DuplicateToTimeSeriesVertex, ElementWiseVertex,
                       GraphVertex, L2NormalizeVertex, L2Vertex,
                       LastTimeStepVertex, MergeVertex, PoolHelperVertex,
                       PreprocessorVertex, ReshapeVertex, ScaleVertex,
                       ShiftVertex, StackVertex, SubsetVertex, UnstackVertex)
