"""AdamW with optional blockwise-int8 moment states (8-bit optimizer).

The reference's ``optim/adamw.py`` on the port's parameter trees (nested
dicts of tensors). ``state_bits=8`` stores m and v as int8 codes plus
one f32 absmax scale per 256-value block (v in sqrt space, so a linear
grid keeps small second moments), dequantized, updated and requantized
each step; the codes are byte-equal to the compiled reference's.
``master=True`` keeps an f32 copy of the parameters in the state, for
bf16 live parameters. Moments exist for float leaves only: integer
leaves, QTensors and None get None.
"""

from __future__ import annotations

import math

import torch

from ..tree import leaves_with_path, map_like
from .compression import quantize_grads_int8

__all__ = ["adamw_init", "adamw_update"]


def _is_float(p) -> bool:
    return isinstance(p, torch.Tensor) and p.is_floating_point()


def _q8(x: torch.Tensor) -> dict:
    codes, scale = quantize_grads_int8(x)
    return {"codes": codes, "scale": scale}


def _dq8(q: dict, ref: torch.Tensor) -> torch.Tensor:
    """Dequantize against the shape of the matching parameter leaf."""
    flat = (q["codes"].to(torch.float32) * q["scale"]).reshape(-1)
    return flat[:math.prod(ref.shape)].reshape(ref.shape)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and "codes" in x


def _first_device(tree):
    for _, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def adamw_init(params, state_bits: int = 32, master: bool = False):
    """{"m", "v", "step"} (and "master" with ``master=True``) over
    ``params``' structure."""
    def mk(p):
        if not _is_float(p):
            return None
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q8(z) if state_bits == 8 else z

    st = {"m": map_like(mk, params), "v": map_like(mk, params),
          "step": torch.zeros((), dtype=torch.int32, device=_first_device(params))}
    if master:
        st["master"] = map_like(lambda p: p.to(torch.float32) if _is_float(p) else None,
                                params)
    return st


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0, clip_norm: float = 1.0, state_bits: int = 32):
    """Returns (new_params, new_state, metrics). ``lr`` is a float or an
    f32 tensor; nothing is read back to the host. Leaf by leaf, so only
    one leaf's temporaries are alive at a time."""
    step = state["step"] + 1

    # global-norm clipping, summed in the reference's leaf order (sorted keys)
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for _, g in sorted(leaves_with_path(grads)) if g is not None]
    gnorm = torch.sqrt(sum(sq[1:], sq[0])) if sq else torch.zeros((), device=step.device)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    has_master = "master" in state

    def upd(p, g, m, v, mp):
        if g is None or m is None:
            return p, m, v, mp
        g = g.to(torch.float32) * scale
        m_f = _dq8(m, p) if _is_q8(m) else m
        # v is stored in sqrt space (see the module docstring)
        v_f = torch.square(_dq8(v, p)) if _is_q8(v) else v
        m_f = b1 * m_f + (1 - b1) * g
        v_f = b2 * v_f + (1 - b2) * g * g
        u = (m_f / bc1) / (torch.sqrt(v_f / bc2) + eps)
        src = mp if mp is not None else p.to(torch.float32)
        if weight_decay:
            u = u + weight_decay * src
        new_master = src - lr * u
        new_p = new_master.to(p.dtype)
        if _is_q8(m):
            m_f, v_f = _q8(m_f), _q8(torch.sqrt(v_f))
        return new_p, m_f, v_f, (new_master if mp is not None else None)

    mp_tree = state["master"] if has_master else map_like(lambda _: None, params)
    out = map_like(upd, params, grads, state["m"], state["v"], mp_tree)

    def part(i):
        return map_like(lambda o, _: o[i], out, params)

    new_state = {"m": part(1), "v": part(2), "step": step}
    if has_master:
        new_state["master"] = part(3)
    return part(0), new_state, {"grad_norm": gnorm}
