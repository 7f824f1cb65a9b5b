from .synthetic import (INDIC_LANGS, LANG_CODES, OVERSEAS_LANGS, SyntheticLM,
                        SyntheticTranslation, batch_iterator, make_batch, pairs)

__all__ = ["LANG_CODES", "INDIC_LANGS", "OVERSEAS_LANGS", "pairs",
           "SyntheticTranslation", "SyntheticLM", "make_batch", "batch_iterator"]
