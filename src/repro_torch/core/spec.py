"""QuantSpec — the composable quantization-spec surface (paper Fig. 10).

Weights, activations and the KV cache each pick a format independently.
Every entry point accepts a ``QuantSpec``, a registered alias or a
grammar string, resolved in one place (:func:`resolve_spec`).

Grammar (one ``w`` field, the rest optional, in this order)::

    w<fmt> [a<fmt>] [kv<fmt>] [x<fmt>] [e<fmt>] [g<int>] [dq]

    w   weight storage         4|8|16|fp4|nf4|fp8|fp8e4m3|fp8e5m2|f32 ...
    a   activation format      8 (int8) | fp8 | 16 (bf16, default)
    kv  KV-cache storage       8 | fp8 | 16 (default) | f32
    x   attention-matmul format (QK/PV operands): 8 | fp8 | 16 (default)
    e   embedding storage      default: int8 for 4-bit weights, else = w
    g   weight block size      g0 = per-channel; default 64, or
                               per-channel when w8 meets a8
    dq  double-quantize the block scales (QLoRA trick)

``str(spec)`` is the canonical grammar form and round-trips.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch

from .formats import FORMATS

__all__ = ["QuantSpec", "ALIASES", "resolve_spec", "SPEC_GRAMMAR"]

SPEC_GRAMMAR = "w<fmt>[a<fmt>][kv<fmt>][x<fmt>][e<fmt>][g<int>][dq]"

_TOKENS = {
    "4": "int4", "8": "int8", "16": "bf16",
    "int4": "int4", "int8": "int8", "bf16": "bf16", "f32": "f32",
    "fp4": "fp4", "nf4": "nf4",
    "fp8": "fp8", "fp8e4m3": "fp8", "fp8e5m2": "fp8_e5m2",
}
_CANON = {"int4": "4", "int8": "8", "bf16": "16", "f32": "f32",
          "fp4": "fp4", "nf4": "nf4", "fp8": "fp8", "fp8_e5m2": "fp8e5m2"}

_ACT_FMTS = ("bf16", "int8", "fp8")
_KV_FMTS = ("bf16", "f32", "int8", "fp8")

_FMT_ALT = "|".join(sorted(_TOKENS, key=len, reverse=True))
_SPEC_RE = re.compile(
    rf"^w(?P<w>{_FMT_ALT})(?:a(?P<a>{_FMT_ALT}))?(?:kv(?P<kv>{_FMT_ALT}))?"
    rf"(?:x(?P<x>{_FMT_ALT}))?"
    rf"(?:e(?P<e>{_FMT_ALT}))?(?:g(?P<g>\d+))?(?P<dq>dq)?$")


def _default_embed(weights: str) -> str:
    """Embeddings ride at int8 under 4-bit weights, otherwise share the
    weight format."""
    return {"int4": "int8", "fp4": "int8", "nf4": "int8"}.get(weights, weights)


def _default_group(weights: str, act: str) -> int:
    """0 = per-channel (one K-block) for w8a8, else a 64-value block."""
    return 0 if (weights == "int8" and act == "int8") else 64


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """A validated precision mix: weight/act/KV formats + block layout."""

    weights: str = "bf16"
    act: str = "bf16"
    kv: str = "bf16"
    attn: str = "bf16"
    embed: Optional[str] = None
    group: Optional[int] = None
    double_quant: bool = False

    def __post_init__(self):
        if self.weights not in FORMATS:
            raise ValueError(f"unknown weight format {self.weights!r}; have "
                             f"{sorted(FORMATS)}")
        if self.act not in _ACT_FMTS:
            raise ValueError(f"activation format must be one of {_ACT_FMTS}, "
                             f"got {self.act!r}")
        if self.act != "bf16" and FORMATS[self.weights].kind == "none":
            raise ValueError(
                f"activation format {self.act!r} requires quantized weights, "
                f"but {self.weights!r} is a passthrough")
        if self.kv not in _KV_FMTS:
            raise ValueError(f"KV-cache format must be one of {_KV_FMTS}, "
                             f"got {self.kv!r}")
        if self.attn not in _ACT_FMTS:
            raise ValueError(f"attention-matmul format must be one of "
                             f"{_ACT_FMTS}, got {self.attn!r}")
        if self.embed is None:
            object.__setattr__(self, "embed", _default_embed(self.weights))
        elif self.embed not in FORMATS:
            raise ValueError(f"unknown embed format {self.embed!r}; have "
                             f"{sorted(FORMATS)}")
        if self.group is None:
            object.__setattr__(self, "group",
                               _default_group(self.weights, self.act))
        elif self.group < 0:
            raise ValueError(f"group must be >= 0, got {self.group}")

    @classmethod
    def parse(cls, text: str) -> "QuantSpec":
        m = _SPEC_RE.match(text.strip())
        if not m:
            raise ValueError(
                f"{text!r} does not match the spec grammar {SPEC_GRAMMAR}")
        g = m.group("g")
        return cls(
            weights=_TOKENS[m.group("w")],
            act=_TOKENS[m.group("a")] if m.group("a") else "bf16",
            kv=_TOKENS[m.group("kv")] if m.group("kv") else "bf16",
            attn=_TOKENS[m.group("x")] if m.group("x") else "bf16",
            embed=_TOKENS[m.group("e")] if m.group("e") else None,
            group=int(g) if g is not None else None,
            double_quant=m.group("dq") is not None)

    def __str__(self) -> str:
        out = ["w", _CANON[self.weights]]
        if self.act != "bf16":
            out += ["a", _CANON[self.act]]
        if self.kv != "bf16":
            out += ["kv", _CANON[self.kv]]
        if self.attn != "bf16":
            out += ["x", _CANON[self.attn]]
        if self.embed != _default_embed(self.weights):
            out += ["e", _CANON[self.embed]]
        if self.group != _default_group(self.weights, self.act):
            out += ["g", str(self.group)]
        if self.double_quant:
            out.append("dq")
        return "".join(out)

    def policy(self, name: Optional[str] = None):
        """The PrecisionPolicy that quantizes a parameter tree per this spec."""
        from .policy import PrecisionPolicy
        return PrecisionPolicy(
            name=name or str(self),
            weights=self.weights, embed=self.embed, kv_cache=self.kv,
            act=self.act,
            block_size=self.group if self.group > 0 else 2 ** 20,
            double_quant=self.double_quant,
            compute_dtype=torch.float32 if self.weights == "f32"
            else torch.bfloat16)

    @property
    def quantizes_act(self) -> bool:
        return self.act != "bf16"

    @property
    def quantizes_attn(self) -> bool:
        return self.attn != "bf16"


ALIASES: Dict[str, QuantSpec] = {
    "f32": QuantSpec(weights="f32"),
    "bf16": QuantSpec(),
    "int8": QuantSpec(weights="int8"),
    "w8a8": QuantSpec(weights="int8", act="int8", kv="int8"),
    "fp8": QuantSpec(weights="fp8", kv="fp8"),
    "int4": QuantSpec(weights="int4", kv="int8"),
    "fp4": QuantSpec(weights="fp4", kv="int8"),
    "nf4": QuantSpec(weights="nf4", kv="int8", double_quant=True),
    "fp8e2e": QuantSpec(weights="fp8", act="fp8", kv="fp8"),
}


def resolve_spec(spec) -> QuantSpec:
    """Accepts a QuantSpec, a registered alias name, or a grammar string."""
    if isinstance(spec, QuantSpec):
        return spec
    if isinstance(spec, str):
        if spec in ALIASES:
            return ALIASES[spec]
        try:
            return QuantSpec.parse(spec)
        except ValueError as e:
            raise ValueError(
                f"unknown quantization spec {spec!r} ({e}); use an alias "
                f"from {sorted(ALIASES)} or the grammar {SPEC_GRAMMAR} "
                f"with formats {sorted(_TOKENS)}") from None
    raise TypeError(
        f"spec must be a QuantSpec or string, got {type(spec).__name__}")
