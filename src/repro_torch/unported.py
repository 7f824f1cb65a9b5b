"""The one place that names what a later port slice brings.

A route of the reference that this package does not run yet raises
``NotImplementedError`` through :func:`later`, naming the slice (see
ROADMAP.md, queue 1); nothing runs another route in its place.
"""

# slice 2 (the serving features), slice 3 (the quantization routes:
# act-quantizing specs, fp8 KV caches, calibration, QLoRA), slice 4
# (every model family, served and trained), slice 5 (scale-out:
# tensor-parallel text enc-dec engines, replica routing, the compressed
# all-reduce, sharded restore) and the first parts of slice 6 (meshes for
# the dense, VLM, MoE (expert parallelism), audio, SSM and hybrid
# families, composed dp x tp stacks, every quantization arm under a mesh:
# act-quantizing and x<fmt> specs, calibration, QLoRA adapters, a draft
# arm; and the clock-driven arms under a mesh, sla=, faults= and a
# request's deadline_ms decided on rank 0's clock through a per-round
# control channel, with the composed stack's on_token and --metrics-port)
# have landed
SLICES = {
    6: ("scale-out, the rest: the sequence split for a width or a KV-head count "
        "that tp does not divide, and a shard-first deploy"),
}


def later(what: str, slice_no: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with port slice {slice_no} "
        f"({SLICES[slice_no]}; ROADMAP.md queue 1)")
