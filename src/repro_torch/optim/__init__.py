from .adamw import adamw_init, adamw_update
from .compression import compressed_psum, quantize_grads_int8
from .schedules import warmup_cosine, warmup_linear

__all__ = ["adamw_init", "adamw_update", "warmup_cosine", "warmup_linear",
           "compressed_psum", "quantize_grads_int8"]
