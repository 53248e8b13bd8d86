"""Keras HDF5 model import (reference deeplearning4j-modelimport): the port
of `deeplearning4j_tpu/keras_import`, with the same exports. Files are read
by the port's own HDF5 loader (`hdf5.py`); h5py is not needed.

    from deeplearning4j_torch.keras_import import KerasModelImport
    net = KerasModelImport.import_keras_sequential_model_and_weights("m.h5")
    graph = KerasModelImport.import_keras_model_and_weights("m.h5",
                                                            device="cpu")
"""
from .model_import import KerasModelImport
from .reader import (Hdf5Archive, InvalidKerasConfigurationException,
                     UnsupportedKerasConfigurationException)
