"""The one place that names what a later port slice brings.

A route of the reference that this package does not run yet raises
``NotImplementedError`` through :func:`later`, naming the slice (see
ROADMAP.md, queue 1); nothing runs another route in its place.
"""

# slice 2 (the serving features), slice 3 (the quantization routes:
# act-quantizing specs, fp8 KV caches, calibration, QLoRA) and slice 4
# (every model family, served and trained) have landed
SLICES = {
    5: "scale-out: tensor-parallel meshes and replica routing",
}


def later(what: str, slice_no: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with port slice {slice_no} "
        f"({SLICES[slice_no]}; ROADMAP.md queue 1)")
