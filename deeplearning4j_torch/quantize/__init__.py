"""Post-training quantization for serving: int8 and bfloat16 parameter-tree
transforms and the quantized forwards the layers dispatch to (port of
`deeplearning4j_tpu/quantize/`)."""
from .quantize import (  # noqa: F401
    MODES, QUANT_SCALE, QUANT_WEIGHT, QUANT_ZERO, AlreadyQuantizedError,
    QuantSpec, dense_qforward, dequantize_tree, embedding_qlookup,
    matmul_any, quantize_tree, sidecar_scales, tree_precision,
)
