"""Quantization core of the port: formats, blockwise PTQ, QTensor,
QuantSpec and the quantized matmul front-end."""

from .formats import FORMATS, Format, get_format
from .policy import PrecisionPolicy, quantize_tree, tree_nbytes
from .qlinear import embed_lookup, qmatmul
from .qtensor import QTensor, maybe_dequantize
from .quantize import dequantize_blockwise, quantize_blockwise
from .spec import ALIASES, SPEC_GRAMMAR, QuantSpec, resolve_spec

__all__ = ["FORMATS", "Format", "get_format", "QuantSpec", "resolve_spec",
           "ALIASES", "SPEC_GRAMMAR", "PrecisionPolicy", "quantize_tree",
           "tree_nbytes", "QTensor", "maybe_dequantize", "quantize_blockwise",
           "dequantize_blockwise", "qmatmul", "embed_lookup"]
