"""Data pipeline: DataSets, iterators, readers, fetchers, normalizers
(reference deeplearning4j-core datasets/* and the DataVec glue); the port of
`deeplearning4j_tpu/data`, with the same exports.
"""
from .dataset import DataSet, MultiDataSet
from .export import ExportedDataSetIterator, export_datasets
from .fetchers import (CifarDataSetIterator, CurvesDataSetIterator,
                       IrisDataSetIterator, LFWDataSetIterator,
                       MnistDataSetIterator)
from .images import ImageRecordReader, ImageRecordReaderDataSetIterator
from .iterators import (AsyncDataSetIterator, AsyncMultiDataSetIterator,
                        AsyncShieldDataSetIterator,
                        AsyncShieldMultiDataSetIterator,
                        DataSetIterator, ExistingDataSetIterator,
                        ListDataSetIterator)
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,
                          NormalizerStandardize)
from .records import (CSVRecordReader, CSVSequenceRecordReader,
                      RecordReaderDataSetIterator,
                      SequenceRecordReaderDataSetIterator)
