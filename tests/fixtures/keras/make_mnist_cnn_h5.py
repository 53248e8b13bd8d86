"""Write the full-width Keras fixture mnist_cnn.h5 and its expected outputs.

    python tests/fixtures/keras/make_mnist_cnn_h5.py

The model is Keras's own examples/mnist_cnn.py: Conv2D 32 3x3 relu, Conv2D
64 3x3 relu, MaxPooling 2x2, Dropout 0.25, Flatten, Dense 128 relu, Dropout
0.5, Dense 10 softmax, compiled with categorical crossentropy (1,199,882
parameters). The file is written with h5py alone (no Keras), in the layout
Keras 2's `model.save` gives an .h5 file: `model_config` and
`training_config` as variable-length string attributes, each layer's
weights at `model_weights/<layer>/<layer>/kernel:0` named by the layer's
`weight_names` and the model's `layer_names` (fixed-length byte strings,
as Keras 2 writes them), and the library's earliest file format. The
weights are Glorot-uniform draws (biases normal(0, 0.01)) from a fixed
numpy seed.

It also writes mnist_cnn_expected.npz: 128 inputs in [0, 1) and the
outputs of the JAX package's importer on them (run on the CPU).
"""
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import h5py  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

SEED = 2121


def conv(name, filters, first=False):
    cfg = {"name": name, "trainable": True, "dtype": "float32",
           "filters": filters, "kernel_size": [3, 3], "strides": [1, 1],
           "padding": "valid", "data_format": "channels_last",
           "dilation_rate": [1, 1], "activation": "relu", "use_bias": True,
           "kernel_initializer": {"class_name": "VarianceScaling", "config": {
               "scale": 1.0, "mode": "fan_avg", "distribution": "uniform",
               "seed": None}},
           "bias_initializer": {"class_name": "Zeros", "config": {}},
           "kernel_regularizer": None, "bias_regularizer": None,
           "activity_regularizer": None, "kernel_constraint": None,
           "bias_constraint": None}
    if first:
        cfg["batch_input_shape"] = [None, 28, 28, 1]
    return {"class_name": "Conv2D", "config": cfg}


def dense(name, units, activation):
    return {"class_name": "Dense", "config": {
        "name": name, "trainable": True, "dtype": "float32", "units": units,
        "activation": activation, "use_bias": True,
        "kernel_initializer": {"class_name": "VarianceScaling", "config": {
            "scale": 1.0, "mode": "fan_avg", "distribution": "uniform",
            "seed": None}},
        "bias_initializer": {"class_name": "Zeros", "config": {}},
        "kernel_regularizer": None, "bias_regularizer": None,
        "activity_regularizer": None, "kernel_constraint": None,
        "bias_constraint": None}}


LAYERS = [
    conv("conv2d_1", 32, first=True),
    conv("conv2d_2", 64),
    {"class_name": "MaxPooling2D", "config": {
        "name": "max_pooling2d_1", "trainable": True, "dtype": "float32",
        "pool_size": [2, 2], "padding": "valid", "strides": [2, 2],
        "data_format": "channels_last"}},
    {"class_name": "Dropout", "config": {
        "name": "dropout_1", "trainable": True, "dtype": "float32",
        "rate": 0.25, "noise_shape": None, "seed": None}},
    {"class_name": "Flatten", "config": {
        "name": "flatten_1", "trainable": True, "dtype": "float32",
        "data_format": "channels_last"}},
    dense("dense_1", 128, "relu"),
    {"class_name": "Dropout", "config": {
        "name": "dropout_2", "trainable": True, "dtype": "float32",
        "rate": 0.5, "noise_shape": None, "seed": None}},
    dense("dense_2", 10, "softmax"),
]
MODEL_CONFIG = {"class_name": "Sequential",
                "config": {"name": "sequential_1", "layers": LAYERS}}
TRAINING_CONFIG = {
    "optimizer_config": {"class_name": "Adadelta", "config": {
        "learning_rate": 1.0, "rho": 0.95, "decay": 0.0, "epsilon": 1e-7}},
    "loss": "categorical_crossentropy", "metrics": ["accuracy"],
    "weighted_metrics": None, "sample_weight_mode": None,
    "loss_weights": None}
# layer -> its weights' shapes (Keras layout: HWIO kernels, [in, out] dense)
SHAPES = {"conv2d_1": ((3, 3, 1, 32), (32,)),
          "conv2d_2": ((3, 3, 32, 64), (64,)),
          "dense_1": ((9216, 128), (128,)),
          "dense_2": ((128, 10), (10,))}


def weights(rng):
    out = {}
    for name, (kshape, bshape) in SHAPES.items():
        receptive = int(np.prod(kshape[:-2])) if len(kshape) == 4 else 1
        fan_in, fan_out = kshape[-2] * receptive, kshape[-1] * receptive
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        out[name] = (rng.uniform(-limit, limit, kshape).astype(np.float32),
                     rng.normal(0.0, 0.01, bshape).astype(np.float32))
    return out


def write(path, w):
    vlen = h5py.string_dtype()
    with h5py.File(path, "w", libver="earliest") as f:
        f.attrs.create("keras_version", "2.2.4", dtype=vlen)
        f.attrs.create("backend", "tensorflow", dtype=vlen)
        f.attrs.create("model_config", json.dumps(MODEL_CONFIG), dtype=vlen)
        f.attrs.create("training_config", json.dumps(TRAINING_CONFIG),
                       dtype=vlen)
        mw = f.create_group("model_weights")
        names = [lc["config"]["name"] for lc in LAYERS]
        mw.attrs["layer_names"] = np.array([n.encode() for n in names])
        mw.attrs["backend"] = np.bytes_(b"tensorflow")
        mw.attrs["keras_version"] = np.bytes_(b"2.2.4")
        for name in names:
            g = mw.create_group(name)
            if name not in w:
                g.attrs["weight_names"] = np.array([])
                continue
            wn = [f"{name}/kernel:0", f"{name}/bias:0"]
            g.attrs["weight_names"] = np.array([n.encode() for n in wn])
            for n, arr in zip(wn, w[name]):
                g.create_dataset(n, data=arr)


def main():
    rng = np.random.default_rng(SEED)
    path = os.path.join(HERE, "mnist_cnn.h5")
    write(path, weights(rng))
    x = rng.random((128, 28, 28, 1), dtype=np.float32)
    from deeplearning4j_tpu.keras_import import KerasModelImport
    net = KerasModelImport.import_keras_sequential_model_and_weights(path)
    y = np.asarray(net.output(x), np.float32)
    np.savez(os.path.join(HERE, "mnist_cnn_expected.npz"), x=x, y=y)
    print(f"wrote {path} ({os.path.getsize(path)} bytes, "
          f"{net.num_params()} parameters) and mnist_cnn_expected.npz "
          f"(x {x.shape}, y {y.shape})")


if __name__ == "__main__":
    main()
