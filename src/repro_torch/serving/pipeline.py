"""One-call deployment: config -> model -> quantize -> engine.

    pipe = deploy("nllb600m", "int4")        # dense KV cache, on the card
    outs = pipe.translate(src_tokens, "ita",
                          SamplingParams(max_new_tokens=8, eos_id=2))
    pipe = deploy("nllb600m", "int4", paged=True)       # block-paged KV
    outs = pipe.translate(src_tokens, "ita",
                          SamplingParams(temperature=0.7, top_p=0.9, seed=1))
    for tok in pipe.translate_stream(src_row, "ita", sp):  # token at a time
        print(tok)
    pipe = deploy("nllb600m", "int4", draft_spec="nf4")  # speculative decoding
    pipe = deploy("nllb600m", "w8a8", calib_batches=batches)  # static act scales
    pipe = deploy("nllb600m", "int4", mesh=tp_mesh(2))   # on each of 2 ranks
    pipe = deploy("qwen2.5-14b", "int4", paged=True)     # a decoder-only LM
    outs = pipe.generate([prompt_ids, ...], SamplingParams(max_new_tokens=8))
    pipe = deploy("olmoe-1b-7b", "int4", paged=True)     # an MoE LM, the same
    pipe = deploy("whisper-base", "int4", paged=True)    # audio: frame prompts
    outs = pipe.generate([{"frames": f, "tgt_in": t}, ...])

``deploy`` runs on the CUDA device unless the caller passes ``device``
(the tests pass ``device="cpu"``); without a card it raises. Kernel
routes come in named bundles, as in the reference: ``"kernels"`` (the
default: the qmm kernel for 4-bit matmuls, the paged-attention kernel
for decoder self-attention) and ``"torch"`` (dequantize + torch matmul,
gathered chains). ``matmul_impl`` / ``paged_attn_impl`` override single
routes. The FASST activation kernel is the ``Ctx.use_fasst_kernel`` knob.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Union

import torch

from ..configs import get_config, reduce_config
from ..core import QuantSpec, calibrated_ctx, quantize_tree, resolve_spec, tree_nbytes
from ..data import LANG_CODES
from ..models import Ctx, build_model
from ..obs import TraceConfig, Tracer
from ..parallel.tp import refuse_under_mesh, shard_params, tp_engine_parts
from .engine import ServeEngine
from .metrics import SLATarget
from .params import Request, RequestOutput, SamplingParams
from .spec_decode import build_draft_arm

__all__ = ["deploy", "TranslationPipeline", "impl_routes", "DEFAULT_IMPL",
           "IMPL_CHOICES"]

_IMPL_ROUTES = {
    "torch": {"matmul_impl": "torch", "paged_attn_impl": "gather"},
    "kernels": {"matmul_impl": "kernel", "paged_attn_impl": "kernel"},
}
DEFAULT_IMPL = "kernels"
IMPL_CHOICES = tuple(sorted(_IMPL_ROUTES))     # the CLIs' --impl choices


def impl_routes(impl: str) -> dict:
    """deploy() kwargs for the named kernel-route bundle."""
    if impl not in _IMPL_ROUTES:
        raise KeyError(f"unknown impl bundle {impl!r}; have {sorted(_IMPL_ROUTES)}")
    return dict(_IMPL_ROUTES[impl])


@dataclasses.dataclass
class TranslationPipeline:
    """A deployed model + scheduler-owned engine behind two calls.

    ``model``, ``params`` and ``ctx`` are what the engine serves: under a
    tensor-parallel mesh, the rank's local model, its shard of the weights
    and the ctx that carries the group (no whole quantized tree is kept
    beside the shard)."""

    cfg: Any
    model: Any
    params: Any
    engine: ServeEngine
    ctx: Ctx
    policy: str                   # the spec as the caller named it
    fp_bytes: int                 # parameter bytes before quantization
    quantized_bytes: int          # the whole model's bytes after it (every rank's)
    spec: QuantSpec               # the resolved quantization spec
    draft_spec: Optional[QuantSpec] = None   # the speculative draft arm's

    @property
    def spec_str(self) -> str:
        """Canonical grammar spelling of the deployed spec."""
        return str(self.spec)

    @property
    def draft_spec_str(self) -> Optional[str]:
        """Canonical spelling of the draft spec (None without a draft arm)."""
        return str(self.draft_spec) if self.draft_spec is not None else None

    @property
    def compression(self) -> float:
        return self.fp_bytes / max(self.quantized_bytes, 1)

    @property
    def tracer(self) -> Optional[Tracer]:
        """The engine's Tracer when deployed with ``trace=...``; dump it
        with ``pipe.tracer.dump_json(path)``."""
        return self.engine.trace

    def generate(self, prompts: Sequence[Any],
                 params: Optional[SamplingParams] = None) -> List[RequestOutput]:
        """Serve a list of prompts: B=1 batch dicts (or Requests), or, for
        an LM, 1-D sequences of token ids; outputs come back in input
        order."""
        ids = [self.engine.submit(self._prompt(p), params) for p in prompts]
        by_id = {o.request_id: o for o in self.engine.run_until_drained()}
        return [by_id[i] for i in ids]

    def _prompt(self, p):
        """A batch dict or Request as it is; an LM's 1-D token ids as
        ``{"tokens": (1, S)}``."""
        if isinstance(p, (dict, Request)):
            return p
        if self.cfg.family in ("encdec", "audio"):
            raise TypeError("enc-dec prompts must be batch dicts with "
                            "'src_tokens' and 'tgt_in'")
        return {"tokens": torch.as_tensor(p, dtype=torch.int32)[None]}

    def _need_encdec(self, what: str, instead: str) -> None:
        if self.cfg.family not in ("encdec", "audio"):
            raise TypeError(f"{what}() needs an enc-dec model, got family "
                            f"{self.cfg.family!r}; use {instead}() instead")

    def translate(self, src_tokens, tgt_lang: Union[str, int],
                  params: Optional[SamplingParams] = None) -> List[RequestOutput]:
        """Many-to-many NMT: one output per source row. ``tgt_lang`` is a
        name from ``data.LANG_CODES`` or a raw code-token id; the decoder
        is prompted with that code token."""
        self._need_encdec("translate", "generate")
        return self.generate(_lang_prompts(src_tokens, tgt_lang), params)

    def generate_stream(self, prompt: Any,
                        params: Optional[SamplingParams] = None) -> Iterator[int]:
        """Stream ONE prompt (a B=1 batch dict or a Request, or an LM's 1-D
        token ids): yields token ids as each block lands; the finished
        RequestOutput is the generator's return value. Other requests keep
        being served."""
        return self.engine.stream_request(self._prompt(prompt), params)

    def translate_stream(self, src_tokens, tgt_lang: Union[str, int],
                         params: Optional[SamplingParams] = None) -> Iterator[int]:
        """Streaming translate() of ONE source row: yields target token
        ids as they arrive (the first at prefill) and returns the
        RequestOutput. Batches loop, or submit through
        ``engine.submit(..., on_token=...)`` for interleaved streams."""
        self._need_encdec("translate_stream", "generate_stream")
        prompts = _lang_prompts(src_tokens, tgt_lang)
        if len(prompts) != 1:
            raise ValueError(f"translate_stream() streams one source row, got a "
                             f"batch of {len(prompts)}; loop over rows or submit "
                             "them via engine.submit(on_token=...)")
        return self.engine.stream_request(prompts[0], params)


def _lang_prompts(src_tokens, tgt_lang: Union[str, int]) -> List[dict]:
    """One B=1 prompt per source row, the decoder prompted with the
    target language's code token."""
    code = LANG_CODES[tgt_lang] if isinstance(tgt_lang, str) else tgt_lang
    src = torch.as_tensor(src_tokens, dtype=torch.int32)
    src = src[None] if src.ndim == 1 else src
    return [{"src_tokens": src[i:i + 1],
             "tgt_in": torch.full((1, 1), code, dtype=torch.int32)}
            for i in range(src.shape[0])]


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deploy() runs on the CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions of the "
            "kernels on the CPU")
    return dev


def deploy(arch_or_cfg, policy: Union[str, QuantSpec] = "int4", *,
           slots: int = 4, max_len: int = 64, smoke: bool = False,
           params: Any = None, ctx: Optional[Ctx] = None,
           kv_dtype: Optional[str] = None, init_seed: int = 0,
           paged: bool = False, page_size: int = 8,
           num_pages: Optional[int] = None, max_src_len: Optional[int] = None,
           horizon: int = 1, matmul_impl: Optional[str] = None,
           paged_attn_impl: Optional[str] = None,
           calib_batches: Optional[Iterable[dict]] = None,
           draft_spec=None, draft_lookahead: int = 4, overlap: bool = True,
           sla: Optional[SLATarget] = None, max_pending: Optional[int] = None,
           preempt_limit: int = 3, faults=None,
           trace: Union[Tracer, TraceConfig, None] = None, mesh=None, device=None
           ) -> TranslationPipeline:
    """Build a ready-to-serve TranslationPipeline in one call.

    arch_or_cfg: registry name or a ModelConfig.
    policy:      a QuantSpec, an alias ("int4", "w8a8", "fp8e2e", ...) or a
                 grammar string ("w4a8kv8", "wfp8e4m3afp8kvfp8"); the KV
                 dtype follows the spec unless ``kv_dtype`` overrides, and
                 the spec's activation and attention formats override
                 those of an explicit ``ctx``.
    smoke:       reduce the config to CPU-testable size and compute in
                 f32 (when no ``ctx`` is given).
    params:      a parameter tree (e.g. from ``repro_torch.convert``) on
                 ``device``, quantized here per ``policy`` (QTensors, with
                 their QLoRA adapters, pass through); default: a fresh
                 random init seeded by ``init_seed``.
    paged:       False (default): a dense ``(slots, max_len)`` KV cache with
                 per-request admission at submit. True: a block-paged KV
                 cache (a shared pool of ``num_pages`` pages of
                 ``page_size`` tokens, default slots x pages of
                 ``max_len``) with batched prefill admission and on-demand
                 paging: a request is admitted with its prompt's pages and
                 its chain grows just ahead of each decode horizon. Both
                 give the same token streams.
    horizon:     decode micro-steps fused per host sync.
    calib_batches: sample batches (``data`` dicts with ``src_tokens`` and
                 ``tgt_in``; an LM's with ``tokens``, a VLM's with
                 ``img_embeds`` too) for static activation calibration: when the
                 spec quantizes activations (a8 / afp8 / x<fmt>), they run
                 teacher-forced through the quantized model and the
                 per-site scales replace dynamic per-token quantization.
                 Without them such a spec warns and stays dynamic. Ignored
                 for specs that keep activations in bf16.
    draft_spec:  a spec for a speculative draft arm: the same
                 checkpoint, quantized a second time from the raw tree
                 (``calib_batches`` calibrate it too).
                 Greedy requests decode speculatively (the draft proposes
                 ``draft_lookahead`` tokens, the target verifies them),
                 token for token the target-only stream; sampled requests
                 fall back to target-only rounds.
    matmul_impl / paged_attn_impl: override single routes of the default
                 "kernels" bundle; they replace the routes of an
                 explicit ``ctx``.
    overlap:     True (default): dispatch horizon N+1 on the card before
                 the host waits for and walks horizon N's token block;
                 False: serial rounds. Same token streams either way;
                 horizon=1 is always serial.
    sla:         an SLATarget: a percentile-feedback controller retunes
                 the effective horizon and the paged prefill-group cap
                 against the measured p95 TTFT / TPOT.
    max_pending: bounded admission: ``submit`` raises the typed
                 ``EngineSaturated`` once this many requests are queued.
    preempt_limit: a paged engine whose pool runs out preempts the
                 lowest-priority, youngest request (pages freed, tokens
                 stashed) and resumes it later by prefill replay; a
                 request preempted more than ``preempt_limit`` times
                 retires as ``preempted_limit`` with its prefix. A
                 draft-armed engine reserves whole budgets instead.
    faults:      a FaultPlan: deterministic page exhaustion, NaN logits
                 and clock skew at chosen rounds and dispatches.
    trace:       a TraceConfig (or a Tracer): per-request lifecycle and
                 scheduler phase tracing, read back through
                 ``pipe.tracer``. None adds no clock read to the loop.
    mesh:        a ``("model",)`` mesh from ``cluster.tp_mesh(K)``, inside the
                 ranks of ``cluster.launch_ranks``: every rank calls deploy()
                 with the same arguments and serves the same requests; the
                 rank keeps its shard of the quantized weights and KV
                 storage and sums its row-parallel products over the
                 ranks (an MoE model's experts: E / tp a rank, their
                 outputs gathered; an SSM's heads and an RG-LRU's channels
                 split). The streams are the single-device engine's. The
                 text and audio enc-decs and every LM family at every
                 spec, dense or paged (the SSM and hybrid dense only, as
                 on one device), with every quantization arm: an
                 act-quantizing spec's dynamic scale at a row-parallel
                 product is the whole row's (the ranks' absmax reduced by
                 max), ``calib_batches`` calibrate on the rank's shard and
                 the ranks' site tables merge by max, QLoRA adapters split
                 with their weights, and a draft arm is quantized from the
                 whole raw tree and sharded like the target. ``sla``,
                 ``faults``, ``max_pending`` and a request's
                 ``deadline_ms`` serve too: what reads a clock (an
                 expiry, an SLA retune) is decided on the group's rank 0,
                 on its clock, and broadcast at each round boundary, so
                 every rank retires and retunes alike (a retune lands at
                 most a round later than on one device; the streams do
                 not depend on it). Any K serves: a sublayer whose width
                 K does not divide (query heads, a KV-head count that
                 neither divides K nor is divided by it, FFN columns,
                 RG-LRU channels, SSD heads, experts) is replicated, run
                 whole on every rank with no collective, and a
                 replicated attention's dense self-attention cache
                 splits its sequence where K divides it
                 (``parallel.tp``).
    device:      None = "cuda" (raises without a card).
    """
    spec = resolve_spec(policy)
    cfg = get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) else arch_or_cfg
    if smoke:
        cfg = reduce_config(cfg)
    if mesh is not None:            # refuse before any build work
        size = getattr(mesh, "size", None)
        refuse_under_mesh(cfg, tp=size() if callable(size) else None)
    kv = kv_dtype or spec.kv
    dev = _device(device)
    model = build_model(cfg, dev)
    if ctx is None:
        ctx = Ctx(compute_dtype=torch.float32 if smoke else torch.bfloat16)
    routes = impl_routes(DEFAULT_IMPL)
    if matmul_impl is not None:
        routes["matmul_impl"] = matmul_impl
    if paged_attn_impl is not None:
        routes["paged_attn_impl"] = paged_attn_impl
    # the spec owns the activation formats, even over an explicit ctx: a
    # caller's ctx must not run a w8a8 spec with bf16 activations
    ctx = dataclasses.replace(ctx, act_fmt=spec.act, attn_act_fmt=spec.attn, **routes)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(init_seed))
    fp_bytes = tree_nbytes(params)
    raw_params = params             # the draft arm quantizes from here
    if draft_spec is not None and calib_batches is not None \
            and not isinstance(calib_batches, (list, tuple)):
        # both arms calibrate on the same batches: a one-shot iterable
        # would be spent by the target
        calib_batches = list(calib_batches)
    if spec.weights != "f32":
        params = quantize_tree(params, spec.policy())
    q_bytes = tree_nbytes(params)
    place = None
    if mesh is not None:
        # a rank keeps its shard, a model of its local widths and a ctx
        # carrying the group, and drops the whole tree; calibration and
        # the draft arm then run on what the engine serves, as on one
        # device
        whole = model.cfg
        model, params, ctx = tp_engine_parts(model, params, ctx, mesh, dev)
        place = functools.partial(shard_params, cfg=whole, lmodel=model, group=ctx.tp)
    if spec.quantizes_act or spec.quantizes_attn:
        fmt = spec.act if spec.quantizes_act else spec.attn
        ctx = calibrated_ctx(ctx, model, params, calib_batches, fmt,
                             f"spec {spec} quantizes activations")
    draft = None
    if draft_spec is not None:
        draft = build_draft_arm(model, raw_params, ctx, draft_spec,
                                lookahead=draft_lookahead,
                                calib_batches=calib_batches, place=place)
    del raw_params
    engine = ServeEngine(model, params, slots=slots, max_len=max_len,
                         kv_dtype=kv, ctx=ctx, paged=paged, page_size=page_size,
                         num_pages=num_pages, max_src_len=max_src_len,
                         horizon=horizon, draft=draft, overlap=overlap, sla=sla,
                         max_pending=max_pending, preempt_limit=preempt_limit,
                         faults=faults, trace=trace, device=dev)
    name = policy if isinstance(policy, str) else str(spec)
    return TranslationPipeline(cfg, model, params, engine, ctx, name, fp_bytes, q_bytes,
                               spec, draft_spec=draft.spec if draft else None)
