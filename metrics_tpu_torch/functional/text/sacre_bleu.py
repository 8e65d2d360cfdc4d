"""SacreBLEU (counterpart of ``metrics_tpu/functional/text/sacre_bleu.py``).

The same accumulated statistics as BLEU (``bleu.py``); only the host-side
tokenizer differs. The tokenizers follow the sacrebleu specs (mteval-v13a,
international/unicode-punctuation, zh, char, ja-mecab). ``regex`` (``intl``)
and ``MeCab`` (``ja-mecab``) are imported on first use, behind the JAX
package's gates and with its fallbacks.
"""
import re
from typing import Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update
from metrics_tpu_torch.metric import resolve_device

Tensor = torch.Tensor

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char", "ja-mecab")

# CJK unicode ranges (sacrebleu's zh tokenizer spec).
_CJK_RANGES = (
    ("㐀", "䶵"),
    ("一", "龥"),
    ("龦", "龻"),
    ("豈", "鶴"),
    ("侮", "頻"),
    ("並", "龎"),
    ("\U00020000", "\U0002a6d6"),
    ("\U0002f800", "\U0002fa1d"),
    ("＀", "￯"),
    ("⺀", "⻿"),
    ("　", "〿"),
    ("㇀", "㇯"),
    ("⼀", "⿟"),
    ("⿰", "⿿"),
    ("㄀", "ㄯ"),
    ("ㆠ", "ㆿ"),
    ("︐", "︟"),
    ("︰", "﹏"),
    ("☀", "⛿"),
    ("✀", "➿"),
    ("㈀", "㋿"),
    ("㌀", "㏿"),
)

# mteval-v13a post-split regexes.
_13A_RULES = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)

# the unicode-category rules need the third-party ``regex`` module:
# compiled on first use, None where it is missing
_INTL_RULES: Union[None, bool, tuple] = False


def _intl_rules():
    global _INTL_RULES
    if _INTL_RULES is False:
        try:
            import regex as _regex_mod

            _INTL_RULES = (
                (_regex_mod.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
                (_regex_mod.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
                (_regex_mod.compile(r"(\p{S})"), r" \1 "),
            )
        except ImportError:
            _INTL_RULES = None
    return _INTL_RULES


def _apply_rules(line: str, rules) -> str:
    for pattern, repl in rules:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def _unescape_html(line: str) -> str:
    if "&" in line:
        line = line.replace("&quot;", '"').replace("&amp;", "&")
        line = line.replace("&lt;", "<").replace("&gt;", ">")
    return line


def _is_cjk(char: str) -> bool:
    return any(lo <= char <= hi for lo, hi in _CJK_RANGES)


def _tokenize_13a(line: str) -> str:
    line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
    return _apply_rules(_unescape_html(line), _13A_RULES)


def _tokenize_intl(line: str) -> str:
    rules = _intl_rules()
    if rules is None:
        raise ModuleNotFoundError("`intl` tokenizer requires the `regex` package")
    return _apply_rules(line, rules)


def _tokenize_zh(line: str) -> str:
    line = line.strip()
    spaced = []
    for char in line:
        if _is_cjk(char):
            spaced.extend((" ", char, " "))
        else:
            spaced.append(char)
    return _apply_rules(_unescape_html("".join(spaced)), _13A_RULES)


def _tokenize_char(line: str) -> str:
    return " ".join(line.strip())


# ja-mecab: sacrebleu's Japanese tokenizer. Where MeCab is importable it is
# sacrebleu's (``MeCab.Tagger('-Owakati')``); otherwise a deterministic
# fallback segments on Japanese script boundaries (kanji / hiragana /
# katakana / latin runs, punctuation alone), as the JAX package's does, and
# warns once: its token boundaries approximate MeCab's morphemes.

_HIRAGANA = ("ぁ", "ゟ")
_KATAKANA = ("゠", "ヿ")  # includes the prolonged-sound mark
_KANJI_RANGES = (("一", "鿿"), ("㐀", "䶿"), ("豈", "﫿"))

_MECAB_TAGGER: Union[None, bool, object] = None


def _ja_char_class(char: str) -> str:
    if _HIRAGANA[0] <= char <= _HIRAGANA[1]:
        return "hira"
    if _KATAKANA[0] <= char <= _KATAKANA[1]:
        return "kata"
    if any(lo <= char <= hi for lo, hi in _KANJI_RANGES):
        return "kanji"
    if char.isspace():
        return "space"
    if char.isalnum():
        return "word"
    return "punct"


def _segment_ja_fallback(line: str) -> str:
    tokens, run, prev = [], "", None
    for char in line.strip():
        cls = _ja_char_class(char)
        if cls == "space":
            if run:
                tokens.append(run)
                run = ""
            prev = None
            continue
        if cls == "punct":
            if run:
                tokens.append(run)
                run = ""
            tokens.append(char)
            prev = None
            continue
        if cls != prev and run:
            tokens.append(run)
            run = ""
        run += char
        prev = cls
    if run:
        tokens.append(run)
    return " ".join(tokens)


def _tokenize_ja_mecab(line: str) -> str:
    global _MECAB_TAGGER
    if _MECAB_TAGGER is None:
        try:
            import MeCab

            try:
                import ipadic

                _MECAB_TAGGER = MeCab.Tagger(ipadic.MECAB_ARGS + " -Owakati")
            except ImportError:
                _MECAB_TAGGER = MeCab.Tagger("-Owakati")
        except Exception:
            _MECAB_TAGGER = False
            from metrics_tpu_torch.utilities.prints import rank_zero_warn

            rank_zero_warn(
                "ja-mecab tokenizer: MeCab is not installed; falling back to approximate "
                "script-boundary segmentation. Scores are deterministic here but will DIFFER from "
                "environments where MeCab is available — install `mecab-python3` for sacrebleu-"
                "identical Japanese tokenization.",
                UserWarning,
            )
    if _MECAB_TAGGER:
        return _MECAB_TAGGER.parse(line.strip()).strip()
    return _segment_ja_fallback(line)


_TOKENIZERS = {
    "none": lambda line: line,
    "13a": _tokenize_13a,
    "zh": _tokenize_zh,
    "intl": _tokenize_intl,
    "char": _tokenize_char,
    "ja-mecab": _tokenize_ja_mecab,
}


class _SacreBLEUTokenizer:
    """Callable tokenizer: spec-named transform + optional lowercase + split."""

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS}")
        self._fn = _TOKENIZERS[tokenize]
        self._lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = self._fn(line)
        if self._lowercase:
            tokenized = tokenized.lower()
        return tokenized.split()


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """SacreBLEU: BLEU with a standardized, reproducible tokenization.
    ``device`` is where the statistics live (CUDA unless the caller asks for
    the CPU).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    target_lists = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds, target_lists, resolve_device(device), n_gram, tokenizer
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
