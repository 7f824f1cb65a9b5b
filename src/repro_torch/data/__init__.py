from .synthetic import (INDIC_LANGS, LANG_CODES, OVERSEAS_LANGS,
                        SyntheticTranslation, pairs)

__all__ = ["LANG_CODES", "INDIC_LANGS", "OVERSEAS_LANGS", "pairs",
           "SyntheticTranslation"]
