"""Quantization core of the port: formats, blockwise PTQ, QTensor,
QuantSpec, the quantized matmul front-end, activation calibration and
QLoRA adapters."""

from .calibration import (ActSiteStats, ActStats, SiteCollector, calibrate,
                          calibrate_act_scale, calibrate_act_scales, calibrated_ctx)
from .formats import FORMATS, Format, get_format
from .policy import PrecisionPolicy, quantize_tree, tree_nbytes
from .qlinear import (act_quant_eligible, embed_lookup, int8_mac_eligible,
                      qmatmul, quantize_activations, quantize_activations_int8)
from .qlora import (attach_lora, count_adapter_params, extract_adapters,
                    inject_adapters, merge_lora)
from .qtensor import QTensor, maybe_dequantize
from .quantize import dequantize_blockwise, quantize_blockwise
from .spec import ALIASES, SPEC_GRAMMAR, QuantSpec, resolve_spec

__all__ = ["FORMATS", "Format", "get_format", "QuantSpec", "resolve_spec",
           "ALIASES", "SPEC_GRAMMAR", "PrecisionPolicy", "quantize_tree",
           "tree_nbytes", "QTensor", "maybe_dequantize", "quantize_blockwise",
           "dequantize_blockwise", "qmatmul", "embed_lookup",
           "quantize_activations", "quantize_activations_int8",
           "int8_mac_eligible", "act_quant_eligible", "ActSiteStats",
           "SiteCollector", "calibrate_act_scales", "calibrate_act_scale", "calibrated_ctx",
           "ActStats", "calibrate", "attach_lora", "extract_adapters",
           "inject_adapters", "count_adapter_params", "merge_lora"]
