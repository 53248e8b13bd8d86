"""deeplearning4j_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The same config-builder DSL, JSON and networks as the JAX package, run by
PyTorch on an NVIDIA GPU, with the JAX package's Pallas kernels rewritten by
hand for Hopper (``ops/csrc``). Entry points run on CUDA unless the caller
passes ``device="cpu"``. This package imports neither JAX nor
``deeplearning4j_tpu``.
"""

from .nn.conf.builders import (BackpropType, MultiLayerConfiguration,
                               NeuralNetConfiguration, OptimizationAlgorithm)
from .nn.conf.inputs import InputType
from .data.dataset import DataSet, MultiDataSet
from .data.fetchers import (IrisDataSetIterator, MnistDataFetcher,
                            MnistDataSetIterator)
from .data.iterators import (AsyncDataSetIterator, AsyncMultiDataSetIterator,
                             AsyncShieldDataSetIterator,
                             AsyncShieldMultiDataSetIterator, DataSetIterator,
                             ExistingDataSetIterator, ListDataSetIterator)
from .data.normalizers import (DataNormalization, ImagePreProcessingScaler,
                               NormalizerMinMaxScaler, NormalizerStandardize)
from .data.records import (CSVRecordReader, CSVSequenceRecordReader,
                           ListStringRecordReader, RecordReader,
                           RecordReaderDataSetIterator,
                           SequenceRecordReaderDataSetIterator)
from .nn.layers.core import (ActivationLayer, DenseLayer, DropoutLayer,
                             EmbeddingLayer, LossLayer, OutputLayer)
from .nn.layers.convolution import (BatchNormalization, Convolution1DLayer,
                                    ConvolutionLayer, ConvolutionMode,
                                    GlobalPoolingLayer,
                                    LocalResponseNormalization, PoolingType,
                                    Subsampling1DLayer, SubsamplingLayer,
                                    ZeroPaddingLayer)
from .nn.layers.attention import SelfAttentionLayer
from .nn.layers.pretrain import (RBM, AutoEncoder, CenterLossOutputLayer,
                                 VariationalAutoencoder)
from .nn.layers.recurrent import (LSTM, GravesBidirectionalLSTM, GravesLSTM,
                                  RnnOutputLayer)
from .nn.multilayer import MultiLayerNetwork, RnnStateMismatchError
from .nn.graph import (ComputationGraph, DuplicateToTimeSeriesVertex,
                       ElementWiseVertex, GraphVertex, L2NormalizeVertex,
                       L2Vertex, LastTimeStepVertex, MergeVertex,
                       PoolHelperVertex, PreprocessorVertex, ReshapeVertex,
                       ScaleVertex, ShiftVertex, StackVertex, SubsetVertex,
                       UnstackVertex)
from .nn.conf.graph_conf import ComputationGraphConfiguration, GraphBuilder
from .nn.updaters import (Adam, AdaDelta, AdaGrad, AdaMax, ExponentialSchedule,
                          GradientNormalization, InverseSchedule, MapSchedule,
                          Nesterovs, NoOp, PolySchedule, RmsProp, Schedule, Sgd,
                          SigmoidSchedule, StepSchedule)
from .nn.weights import Distribution, WeightInit
from .eval.evaluation import Evaluation, EvaluationBinary, RegressionEvaluation
from .eval.roc import ROC, ROCBinary, ROCMultiClass
from .nn.transfer_learning import (FineTuneConfiguration, TransferLearning,
                                   TransferLearningHelper)
from .optimize.listeners import (CheckpointListener,
                                 CollectScoresIterationListener,
                                 ComposableIterationListener,
                                 EvaluativeListener, IterationListener,
                                 ParamAndGradientIterationListener,
                                 PerformanceListener, ScoreIterationListener)
from .optimize.resilience import (CheckpointManager, DivergenceError,
                                  DivergenceSentinel, RetryPolicy)
from .parallel import (PipelineParallelWrapper, SequenceParallelWrapper,
                       TensorParallelWrapper, pipeline_mesh, seq_parallel_mesh,
                       tensor_parallel_mesh)
from .parallel.inference import InferenceMode, ParallelInference
from .serving import ModelPool, ServingGateway
from .utils.model_serializer import (CheckpointCorruptError, ModelSerializer,
                                     restore_model, save_model)

__version__ = "0.1.0"
