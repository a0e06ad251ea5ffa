"""Text normalization — copy of ``tts_max_tpu/data/normalization.py`` (the
port imports nothing of the JAX package).

- ``BasicTextNormalizer``: dependency-free normalization (NFKC, ascii
  transliteration for English, numeral verbalization, whitespace collapse)
  — the default.
- ``NemoTextNormalizer``: used when nemo_text_processing is importable.
- ``NoOpTextNormalizer``.
"""

from __future__ import annotations

import abc
import re
import unicodedata


class TextNormalizer(abc.ABC):
    @abc.abstractmethod
    def normalize_with_language(self, text: str, language: str) -> str:
        ...

    def normalize(self, text: str, language: str | None = None) -> str:
        """Normalize, detecting the language when the caller doesn't know it
        (inference-time free text carries no language tag)."""
        return self.normalize_with_language(
            text, language or detect_language(text)
        )


class NoOpTextNormalizer(TextNormalizer):
    def normalize_with_language(self, text: str, language: str) -> str:
        return text


_WS = re.compile(r"\s+")


class BasicTextNormalizer(TextNormalizer):
    """NFKC + numeral/currency/time verbalization + (for English) ascii
    transliteration + whitespace collapse (data/verbalize.py for en,
    data/verbalize_multi.py for es/fr/de/zh/ja)."""

    def normalize_with_language(self, text: str, language: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if language == "en":
            from tts_max_tpu_torch.data.verbalize import expand_en

            text = expand_en(text)
            text = (
                unicodedata.normalize("NFKD", text)
                .encode("ascii", "ignore")
                .decode("ascii")
            )
        elif language in ("es", "fr", "de", "zh", "ja"):
            from tts_max_tpu_torch.data.verbalize_multi import expand

            text = expand(text, language)
        return _WS.sub(" ", text).strip()


class NemoTextNormalizer(TextNormalizer):
    """NeMo-backed normalizer (en/ja/zh/es/fr/de), lazy per-language."""

    SUPPORTED = ("en", "ja", "zh", "es", "fr", "de")

    def __init__(self) -> None:
        self._normalizers: dict[str, object] = {}
        self._fallback = BasicTextNormalizer()

    def _get(self, language: str):
        if language not in self._normalizers:
            from nemo_text_processing.text_normalization.normalize import Normalizer

            self._normalizers[language] = Normalizer(
                input_case="cased", lang=language
            )
        return self._normalizers[language]

    def normalize_with_language(self, text: str, language: str) -> str:
        if language not in self.SUPPORTED:
            return self._fallback.normalize_with_language(text, language)
        try:
            out = self._get(language).normalize(text)
        except Exception:
            return self._fallback.normalize_with_language(text, language)
        if language == "en":
            out = self._fallback.normalize_with_language(out, "en")
        return out


# --- language detection ------------------------------------------------------
#
# lingua is used when importable; the air-gapped fallback is a small
# dependency-free heuristic: script detection separates ja/zh (kana is
# exclusive to Japanese; han-only text is Chinese), and Latin-script text is
# scored against stopword + diacritic tables for en/es/fr/de.

_SUPPORTED_LANGS = ("en", "es", "fr", "de", "zh", "ja")

_STOPWORDS = {
    "en": frozenset(
        "the and is are was were to of in it that this with for on you not "
        "be have at by from his her they we what there will would can".split()
    ),
    "es": frozenset(
        "el la los las de que y en un una es no por con para del se su al "
        "lo como más pero sus está son fue muy hay este esta".split()
    ),
    "fr": frozenset(
        "le la les des de du et est en un une que qui dans pour pas au aux "
        "ce cette il elle nous vous sont avec sur être été je ne".split()
    ),
    "de": frozenset(
        "der die das und ist nicht ein eine zu den dem des im mit für auf "
        "sich als auch es an werden aus bei nach wird sind von ich".split()
    ),
}
_DIACRITICS = {
    "es": frozenset("¿¡ñáíóúü"),
    "fr": frozenset("àâçèêëîïôùûœ"),
    "de": frozenset("äöüß"),
}
_WORD = re.compile(r"[^\W\d_]+", re.UNICODE)
_lingua_detector = None


def _detect_heuristic(text: str, default: str = "en") -> str:
    kana = han = 0
    for ch in text:
        o = ord(ch)
        if 0x3040 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF:
            kana += 1
        elif (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF
              or 0xF900 <= o <= 0xFAFF):
            han += 1
    if kana:
        return "ja"
    if han:
        return "zh"
    lower = text.lower()
    words = _WORD.findall(lower)
    if not words:
        return default
    scores = {
        lang: sum(1 for w in words if w in sw)
        for lang, sw in _STOPWORDS.items()
    }
    for lang, marks in _DIACRITICS.items():
        scores[lang] += 2 * sum(1 for ch in lower if ch in marks)
    best = max(scores, key=lambda k: (scores[k], k == default))
    return best if scores[best] > 0 else default


def detect_language(text: str, default: str = "en") -> str:
    """Best-effort language id ('en'/'es'/'fr'/'de'/'zh'/'ja') for routing
    text normalization; ``default`` when undecidable."""
    global _lingua_detector
    if _lingua_detector is None:
        try:
            from lingua import Language, LanguageDetectorBuilder

            _lingua_detector = LanguageDetectorBuilder.from_languages(
                Language.ENGLISH, Language.SPANISH, Language.FRENCH,
                Language.GERMAN, Language.CHINESE, Language.JAPANESE,
            ).build()
        except Exception:
            _lingua_detector = False  # cache the miss: import is slow
    if _lingua_detector:
        try:
            lang = _lingua_detector.detect_language_of(text)
            if lang is not None:
                code = lang.iso_code_639_1.name.lower()
                if code in _SUPPORTED_LANGS:
                    return code
        except Exception:
            pass
    return _detect_heuristic(text, default)


def create(enable: bool = True) -> TextNormalizer:
    """NeMo when available, otherwise the dependency-free normalizer."""
    if not enable:
        return NoOpTextNormalizer()
    try:
        import nemo_text_processing  # noqa: F401

        return NemoTextNormalizer()
    except Exception:
        return BasicTextNormalizer()
