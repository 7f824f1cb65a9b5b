from .synthetic import LANG_CODES

__all__ = ["LANG_CODES"]
