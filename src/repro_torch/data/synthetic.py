"""Deterministic synthetic translation corpus (numpy only; no downloads).

The port's own copy of the reference's ``data/synthetic.py``
``SyntheticTranslation``: parallel (src, tgt) pairs where each
"language" is an affine token permutation, tgt_t =
perm_tgt(inv_perm_src(src_t)), prefixed with the target-language code
token. Token ids 1..N are reserved as target-language codes: the
decoder is prompted with the code of the language to translate into.
The same seed draws the same batches as the reference, byte for byte.
``SyntheticLM`` (a Zipf-ish autoregressive stream with lagged copies),
``make_batch`` (the audio model's frames and the VLM's image embeddings
included) and ``batch_iterator`` are copies too.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LANG_CODES", "INDIC_LANGS", "OVERSEAS_LANGS", "pairs",
           "SyntheticTranslation", "SyntheticLM", "make_batch",
           "batch_iterator"]

# paper Fig. 9 languages (token ids 1..N reserved as language codes)
LANG_CODES = {
    "hin": 1, "tam": 2, "tel": 3, "kan": 4, "ben": 5, "mar": 6,   # Indic
    "eng": 7, "ita": 8, "fra": 9, "deu": 10, "spa": 11, "jpn": 12,  # overseas
}
INDIC_LANGS = ("hin", "tam", "tel", "kan", "ben", "mar")
OVERSEAS_LANGS = ("eng", "ita", "fra", "deu", "spa", "jpn")
_N_RESERVED = 16  # 0 = pad/bos, 1..15 language codes


def pairs(src_langs: Sequence[str] = INDIC_LANGS,
          tgt_langs: Sequence[str] = OVERSEAS_LANGS
          ) -> List[Tuple[str, str]]:
    """Bidirectional (src, tgt) pair grid, both directions of every
    cross-group combination — the paper's Fig. 9 Indic<->overseas
    evaluation matrix by default (6 x 6 x 2 = 72 pairs). Deduplicated
    (order-preserving), so overlapping groups don't double-weight a
    direction."""
    fwd = [(s, t) for s in src_langs for t in tgt_langs if s != t]
    return list(dict.fromkeys(fwd + [(t, s) for s, t in fwd]))


class SyntheticTranslation:
    """Many-to-many parallel corpus over `languages` with shared content.

    ``split`` selects the sentence-content stream: ``"train"`` keeps the
    historical stream bit-for-bit; ``"eval"`` draws from a disjoint
    seeded stream so evaluation never scores on training sentences.
    The per-language permutations (the "languages" themselves) depend
    only on ``(seed, languages)`` and are shared across splits — the
    eval split tests generalization to unseen sentences of the *same*
    translation mapping, which is the point.
    """

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 languages=("hin", "eng", "ita", "tam"),
                 split: str = "train"):
        assert vocab_size > 2 * _N_RESERVED
        if split not in ("train", "eval"):
            raise ValueError(f"split must be 'train' or 'eval', got {split!r}")
        self.vocab = vocab_size
        self.seq = seq_len
        self.langs = list(languages)
        self.split = split
        rng = np.random.default_rng(seed)
        self._perm = {}
        n_content = vocab_size - _N_RESERVED
        for lang in self.langs:
            p = rng.permutation(n_content)
            self._perm[lang] = p
            self._perm[lang + "_inv"] = np.argsort(p)
        # train: the pre-split stream, unchanged; eval: a seed-sequence
        # stream no integer seed of the train form can collide with
        self.rng = np.random.default_rng(seed + 1) if split == "train" \
            else np.random.default_rng([seed + 1, 0x0E7A])

    def _content(self, batch: int) -> np.ndarray:
        # zipf-flavoured content ids in [0, vocab - reserved)
        z = self.rng.zipf(1.3, size=(batch, self.seq - 2)).astype(np.int64)
        return (z - 1) % (self.vocab - _N_RESERVED)

    def sample(self, batch: int, pair: Optional[Tuple[str, str]] = None):
        """Returns dict: src_tokens (B,S), tgt_in (B,S), tgt_out (B,S), mask.

        ``pair=(src_lang, tgt_lang)`` pins the direction (the eval
        suite's per-pair matrix); default draws a random ordered pair.
        """
        if pair is not None:
            src_l, tgt_l = pair
            for lang in (src_l, tgt_l):
                if lang not in self.langs:
                    raise KeyError(
                        f"language {lang!r} not in this corpus "
                        f"(languages={self.langs})")
            if src_l == tgt_l:
                raise ValueError(f"pair must be two languages, got {pair}")
        else:
            src_l, tgt_l = self.rng.choice(self.langs, 2, replace=False)
        content = self._content(batch)
        src = self._perm[src_l][content] + _N_RESERVED
        tgt = self._perm[tgt_l][content] + _N_RESERVED
        code = LANG_CODES[tgt_l]
        B, S = batch, self.seq
        src_tok = np.zeros((B, S), np.int32)
        src_tok[:, 0] = code                      # target code prefixes source
        src_tok[:, 1:S - 1] = src
        tgt_in = np.zeros((B, S), np.int32)
        tgt_in[:, 0] = code                       # decoder starts from code
        tgt_in[:, 1:S - 1] = tgt[:, :S - 2]
        tgt_out = np.zeros((B, S), np.int32)
        tgt_out[:, :S - 2] = tgt
        mask = (tgt_out != 0).astype(np.float32)
        return {"src_tokens": src_tok, "tgt_in": tgt_in,
                "tgt_out": tgt_out, "loss_mask": mask,
                "src_lang": src_l, "tgt_lang": tgt_l}


class SyntheticLM:
    """Autoregressive stream with learnable copy/lag structure."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 lag: int = 4):
        self.vocab = vocab_size
        self.seq = seq_len
        self.lag = lag
        self.rng = np.random.default_rng(seed)

    def sample(self, batch: int):
        z = self.rng.zipf(1.5, size=(batch, self.seq)).astype(np.int64)
        toks = 1 + (z - 1) % (self.vocab - 1)
        # copy structure: token repeats from `lag` back with p=0.5
        copy = self.rng.random((batch, self.seq)) < 0.5
        for t in range(self.lag, self.seq):
            toks[:, t] = np.where(copy[:, t], toks[:, t - self.lag], toks[:, t])
        toks = toks.astype(np.int32)
        mask = np.ones((batch, self.seq), np.float32)
        return {"tokens": toks, "loss_mask": mask}


def make_batch(cfg, shape_spec, seed: int = 0, batch: Optional[int] = None,
               seq: Optional[int] = None):
    """One concrete (host) batch for an (arch x shape) cell."""
    B = batch or shape_spec.global_batch
    S = seq or shape_spec.seq_len
    rng = np.random.default_rng(seed)
    if cfg.family in ("encdec", "audio"):
        ds = SyntheticTranslation(cfg.vocab_size, S, seed)
        b = ds.sample(B)
        if cfg.family == "audio":   # the stub conv frontend's output
            return {"tgt_in": b["tgt_in"], "tgt_out": b["tgt_out"],
                    "loss_mask": b["loss_mask"],
                    "frames": rng.standard_normal(
                        (B, cfg.enc_len, cfg.d_model)).astype(np.float32) * 0.1}
        b["src_tokens"] = b["src_tokens"][:, :cfg.enc_len] if \
            cfg.enc_len < S else b["src_tokens"]
        return b
    b = SyntheticLM(cfg.vocab_size, S, seed).sample(B)
    if cfg.family == "vlm":     # the stub vision frontend's patch embeddings
        P, keep = cfg.num_patches, max(S - cfg.num_patches, 8)
        b["tokens"], b["loss_mask"] = b["tokens"][:, :keep], b["loss_mask"][:, :keep]
        b["img_embeds"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32) * 0.1
    return b


def batch_iterator(cfg, shape_spec, seed: int = 0, batch=None,
                   seq=None) -> Iterator[dict]:
    step = 0
    while True:
        yield make_batch(cfg, shape_spec, seed + step, batch, seq)
        step += 1
