"""String enums shared across the library (counterpart of
``metrics_tpu/utilities/enums.py``; kept as a copy so the port imports
nothing of the JAX package).
"""
from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """Case-insensitive string enum."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError:
            return None

    @classmethod
    def coerce(cls, value: Union[str, "EnumStr", None]) -> Optional["EnumStr"]:
        if value is None:
            return None
        if isinstance(value, cls):
            return value
        out = cls.from_str(str(value))
        if out is None:
            valid = [e.value for e in cls]
            raise ValueError(f"Invalid value {value!r}; expected one of {valid}.")
        return out

    def __str__(self) -> str:
        return self.value


class DataType(EnumStr):
    """Classification input case."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Reduction over classes."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class reduction."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
