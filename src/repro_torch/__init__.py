"""PyTorch/CUDA port of the quantized NMT serving stack.

The package mirrors ``repro`` (the JAX reference) module for module:
``configs``, ``core``, ``kernels``, ``models``, ``serving``. Every TPU
kernel on the served path has a hand-written Hopper counterpart under
``kernels/`` with a plain PyTorch version beside it; entry points run on
the card unless the caller passes ``device="cpu"``.

    from repro_torch.serving import deploy, SamplingParams
    pipe = deploy("nllb600m", "int4", paged=True)          # on the card
    outs = pipe.translate(src_tokens, "ita", SamplingParams(max_new_tokens=32))
"""
