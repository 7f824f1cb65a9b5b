"""Language-code tokens of the paper's Fig. 9 languages.

Token ids 1..N are reserved as target-language codes: the decoder is
prompted with the code of the language to translate into.
"""

LANG_CODES = {
    "hin": 1, "tam": 2, "tel": 3, "kan": 4, "ben": 5, "mar": 6,   # Indic
    "eng": 7, "ita": 8, "fra": 9, "deu": 10, "spa": 11, "jpn": 12,  # overseas
}
