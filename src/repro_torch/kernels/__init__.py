"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the wrappers (``ops``) that pick between them by the tensors' device.

| kernel        | source                | replaces (JAX package)                  |
| qmm           | csrc/qmm.cu (CUDA)    | kernels/qmm.py::qmm_kernel_call         |
| paged_attn    | csrc/paged_attn.cu    | kernels/paged_attn.py::paged_attn_call  |
| decode_attn   | csrc/decode_attn.cu   | kernels/decode_attn.py::decode_attn_call|
| fasst_act     | fasst.py (Triton)     | kernels/fasst.py::fasst_act_call        |
| fasst_softmax | fasst.py (Triton)     | kernels/fasst.py::fasst_softmax_call    |
"""
