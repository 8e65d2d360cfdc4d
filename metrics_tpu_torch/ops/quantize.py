"""Blockwise quantized sync transport: low-bit wire codecs with a stated
error (counterpart of ``metrics_tpu/ops/quantize.py``).

A flat float32 vector is cut into blocks of ``DEFAULT_BLOCK`` lanes; each
block carries one float32 scale, the largest finite magnitude in the
block, floored at the smallest normal float32.

- ``int8``: a finite lane is ``round(x / scale * 126)`` clipped to
  ``[-126, 126]``; the three spare codes carry NaN (``-128``), +inf
  (``127``) and -inf (``-127``) exactly. Absolute error per lane at most
  ``scale / 252``. Wire: 1 byte per lane and 4 per block (1.125 B per lane
  at block 32).
- ``fp16``: a lane is ``x / scale`` as float16 (NaN and ±inf pass).
  Relative error at most ``2**-10`` for lanes of at least ``2**-14`` of the
  block's scale, absolute ``scale * 2**-24`` below. The wire holds int16 bit
  patterns. Wire: 2 bytes per lane and 4 per block.
- ``exact``: float32 in, float32 out, bit for bit.

``encode(x, exact_tail=t)`` ships the last ``t`` lanes bit-exact (counters
riding a packed payload: a sketch's level counts and ``n_seen``).

Two implementations, kept bit-identical: torch functions that run on the
tensor's device (``WireCodec.encode``/``decode``: the wire of
``fused_sync``), and numpy twins (``encode_np``/``decode_np``: the host
wire). Neither flushes denormals; XLA does, so the JAX package's in-graph
codec can differ from these on denormal lanes only, inside the stated
envelope (absolute error below ``2**-126``).

Every wire travels as a byte view (``uint8``): Gloo carries no int16 and
NCCL has no int16 type, and a float16 reduction would quiet a lane that
forms a signalling-NaN pattern. Each lane of a gathered wire has one
writer, so the bytes arrive exactly.

The transport resolves as: the programmatic argument
(``fused_sync(transport=...)``, ``Metric(sync_transport=...)``), else
``METRICS_TPU_SYNC_TRANSPORT``, else ``"exact"``. A malformed variable
warns once and keeps ``exact``; an unknown programmatic name raises.
``kernel_override(sync_transport=...)``, a feature of the JAX package's
dispatch layer, is not ported: the port has no dispatch layer.
"""
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from metrics_tpu_torch.ops._envtools import EnvParse, WarnOnce

Tensor = torch.Tensor

__all__ = [
    "DEFAULT_BLOCK",
    "MAX_CODE",
    "CODE_NAN",
    "CODE_POS_INF",
    "CODE_NEG_INF",
    "TINY_NORMAL",
    "INT8_REL_ERROR_BOUND",
    "FP16_REL_ERROR_BOUND",
    "MIN_HOST_QUANTIZE_SIZE",
    "TRANSPORTS",
    "WireCodec",
    "EXACT_CODEC",
    "FP16_CODEC",
    "INT8_CODEC",
    "validate_transport",
    "resolve_codec",
    "reset_transport_env_state",
    "blockwise_int8_encode_np",
    "blockwise_int8_decode_np",
    "host_encode",
    "host_decode",
    "wrap_gather_transport",
    "encode_leaf",
    "decode_leaf",
    "as_bytes",
    "from_bytes",
    "quantizes_on_host",
]

DEFAULT_BLOCK = 32
MAX_CODE = 126
CODE_NAN = -128
CODE_POS_INF = 127
CODE_NEG_INF = -127
TINY_NORMAL = float(np.float32(2.0 ** -126))
INT8_REL_ERROR_BOUND = 1.0 / (2 * MAX_CODE)
FP16_REL_ERROR_BOUND = 2.0 ** -10
# float leaves smaller than this ship exact on the host wire
MIN_HOST_QUANTIZE_SIZE = 64

TRANSPORTS = ("exact", "fp16", "int8")


def _num_blocks(n: int, block: int) -> int:
    return -(-int(n) // int(block)) if n > 0 else 0


# --------------------------------------------------------------------------
# torch (on the tensor's device)
# --------------------------------------------------------------------------


def _view(t: Tensor, dtype: torch.dtype) -> Tensor:
    """A bitcast of a flat tensor (little-endian, as JAX's
    ``bitcast_convert_type``); an empty tensor gives an empty one."""
    if t.numel() == 0:
        return torch.empty((0,), dtype=dtype, device=t.device)
    t = t.contiguous().reshape(-1)
    if t.storage_offset() * t.element_size() % dtype.itemsize:
        t = t.clone()  # a slice that starts off the new dtype's alignment
    return t.view(dtype)


def _split(x: Tensor, exact_tail: int):
    x = x.to(torch.float32).reshape(-1)
    t = int(exact_tail)
    if not 0 <= t <= x.shape[0]:
        raise ValueError(f"exact_tail={t} out of range for a {x.shape[0]}-lane payload")
    return x[: x.shape[0] - t], x[x.shape[0] - t:]


def _blocked(head: Tensor, block: int):
    nb = _num_blocks(head.shape[0], block)
    x2 = head.new_zeros((nb * block,))
    x2[: head.shape[0]] = head
    return x2.reshape(nb, block), nb


def _block_scales(x2: Tensor):
    """The block scales: the largest finite magnitude, floored at the
    smallest normal float32."""
    finite = torch.isfinite(x2)
    if x2.shape[0] == 0:
        return x2.new_zeros((0,)), finite
    absmax = torch.where(finite, x2.abs(), torch.zeros((), dtype=x2.dtype, device=x2.device)).amax(dim=1)
    return torch.clamp_min(absmax, TINY_NORMAL), finite


def _int8_encode(x: Tensor, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> Tensor:
    head, tail = _split(x, exact_tail)
    x2, _ = _blocked(head, block)
    scales, finite = _block_scales(x2)
    zero = torch.zeros((), dtype=torch.float32, device=x2.device)
    q = torch.clip(torch.round(torch.where(finite, x2, zero) / scales[:, None] * float(MAX_CODE)), -MAX_CODE, MAX_CODE)
    q = q.to(torch.int8)
    q = torch.where(torch.isnan(x2), torch.full_like(q, CODE_NAN), q)
    q = torch.where(x2 == float("inf"), torch.full_like(q, CODE_POS_INF), q)
    q = torch.where(x2 == float("-inf"), torch.full_like(q, CODE_NEG_INF), q)
    return torch.cat([q.reshape(-1), _view(scales, torch.int8), _view(tail, torch.int8)])


def _int8_decode(wire: Tensor, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> Tensor:
    wire = _view(wire, torch.int8)
    t = int(exact_tail)
    h = int(n) - t
    nb = _num_blocks(h, block)
    q = wire[: nb * block].reshape(nb, block)
    scales = _view(wire[nb * block: nb * block + 4 * nb], torch.float32)
    tail = _view(wire[nb * block + 4 * nb: nb * block + 4 * nb + 4 * t], torch.float32)
    vals = q.to(torch.float32) * (scales[:, None] / float(MAX_CODE))
    vals = torch.where(q == CODE_NAN, torch.full_like(vals, float("nan")), vals)
    vals = torch.where(q == CODE_POS_INF, torch.full_like(vals, float("inf")), vals)
    vals = torch.where(q == CODE_NEG_INF, torch.full_like(vals, float("-inf")), vals)
    return torch.cat([vals.reshape(-1)[:h], tail])


def _fp16_encode(x: Tensor, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> Tensor:
    head, tail = _split(x, exact_tail)
    x2, _ = _blocked(head, block)
    scales, _ = _block_scales(x2)
    h16 = (x2 / scales[:, None]).to(torch.float16)
    return _view(torch.cat([h16.reshape(-1), _view(scales, torch.float16), _view(tail, torch.float16)]), torch.int16)


def _fp16_decode(wire: Tensor, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> Tensor:
    wire = _view(wire, torch.float16)
    t = int(exact_tail)
    h = int(n) - t
    nb = _num_blocks(h, block)
    h16 = wire[: nb * block].reshape(nb, block)
    scales = _view(wire[nb * block: nb * block + 2 * nb], torch.float32)
    tail = _view(wire[nb * block + 2 * nb: nb * block + 2 * nb + 2 * t], torch.float32)
    vals = h16.to(torch.float32) * scales[:, None]
    return torch.cat([vals.reshape(-1)[:h], tail])


def _exact_encode(x: Tensor, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> Tensor:
    return x.to(torch.float32).reshape(-1)


def _exact_decode(wire: Tensor, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> Tensor:
    return _view(wire, torch.float32)


# --------------------------------------------------------------------------
# numpy twins (the host wire), bit-identical to the torch functions
# --------------------------------------------------------------------------


def _blocked_np(head: np.ndarray, block: int):
    nb = _num_blocks(head.shape[0], block)
    x2 = np.zeros((nb, block), np.float32)
    x2.reshape(-1)[: head.shape[0]] = head
    return x2, nb


def _block_scales_np(x2: np.ndarray, nb: int):
    finite = np.isfinite(x2)
    absmax = np.max(np.where(finite, np.abs(x2), np.float32(0)), axis=1) if nb else np.zeros((0,), np.float32)
    return np.maximum(absmax, np.float32(TINY_NORMAL)).astype(np.float32), finite


def blockwise_int8_encode_np(x: Any, block: int = DEFAULT_BLOCK):
    """``(codes int8 (nb*block,), scales float32 (nb,))`` of a flat vector."""
    x = np.asarray(x, np.float32).reshape(-1)
    x2, nb = _blocked_np(x, block)
    scales, finite = _block_scales_np(x2, nb)
    q = np.clip(
        np.round(np.where(finite, x2, np.float32(0)) / scales[:, None] * np.float32(MAX_CODE)), -MAX_CODE, MAX_CODE
    ).astype(np.int8)
    q = np.where(np.isnan(x2), np.int8(CODE_NAN), q)
    q = np.where(x2 == np.inf, np.int8(CODE_POS_INF), q)
    q = np.where(x2 == -np.inf, np.int8(CODE_NEG_INF), q)
    return q.reshape(-1), scales


def blockwise_int8_decode_np(codes: Any, scales: Any, n: int, block: int = DEFAULT_BLOCK):
    codes = np.asarray(codes, np.int8).reshape(-1)
    scales = np.asarray(scales, np.float32).reshape(-1)
    nb = _num_blocks(n, block)
    q = codes[: nb * block].reshape(nb, block)
    vals = q.astype(np.float32) * (scales[:, None] / np.float32(MAX_CODE))
    vals = np.where(q == CODE_NAN, np.float32(np.nan), vals)
    vals = np.where(q == CODE_POS_INF, np.float32(np.inf), vals)
    vals = np.where(q == CODE_NEG_INF, np.float32(-np.inf), vals)
    return vals.reshape(-1)[: int(n)]


def _int8_encode_np(x: Any, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1)
    t = int(exact_tail)
    head, tail = x[: x.shape[0] - t], x[x.shape[0] - t:]
    codes, scales = blockwise_int8_encode_np(head, block)
    return np.concatenate([codes, scales.view(np.int8), np.ascontiguousarray(tail).view(np.int8)])


def _int8_decode_np(wire: Any, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> np.ndarray:
    wire = np.asarray(wire).reshape(-1).view(np.int8)
    t = int(exact_tail)
    h = int(n) - t
    nb = _num_blocks(h, block)
    scales = wire[nb * block: nb * block + 4 * nb].view(np.float32)
    tail = wire[nb * block + 4 * nb: nb * block + 4 * nb + 4 * t].view(np.float32)
    head = blockwise_int8_decode_np(wire[: nb * block], scales, h, block)
    return np.concatenate([head, tail])


def _fp16_encode_np(x: Any, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1)
    t = int(exact_tail)
    head, tail = x[: x.shape[0] - t], x[x.shape[0] - t:]
    x2, nb = _blocked_np(head, block)
    scales, _ = _block_scales_np(x2, nb)
    h16 = (x2 / scales[:, None]).astype(np.float16)
    return np.concatenate([h16.reshape(-1), scales.view(np.float16), np.ascontiguousarray(tail).view(np.float16)]).view(np.int16)


def _fp16_decode_np(wire: Any, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> np.ndarray:
    wire = np.asarray(wire).reshape(-1).view(np.float16)
    t = int(exact_tail)
    h = int(n) - t
    nb = _num_blocks(h, block)
    h16 = wire[: nb * block].reshape(nb, block)
    scales = wire[nb * block: nb * block + 2 * nb].view(np.float32)
    tail = wire[nb * block + 2 * nb: nb * block + 2 * nb + 2 * t].view(np.float32)
    vals = h16.astype(np.float32) * scales.reshape(-1, 1)
    return np.concatenate([vals.reshape(-1)[:h], tail])


def _exact_encode_np(x: Any, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1)


def _exact_decode_np(wire: Any, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> np.ndarray:
    return np.asarray(wire).reshape(-1).view(np.float32)


# --------------------------------------------------------------------------
# the codecs and their resolution
# --------------------------------------------------------------------------


class WireCodec(NamedTuple):
    """One wire transport: torch and numpy encode/decode over a flat float32
    payload with an optional bit-exact tail."""

    name: str
    wire_dtype: torch.dtype
    np_wire_dtype: Any
    lanes_per_scale: int  # wire lanes carrying one float32 block scale
    lanes_per_exact: int  # wire lanes carrying one bit-exact float32 lane
    encode: Callable  # (x, exact_tail=0, block=...) -> wire, torch
    decode: Callable  # (wire, n, exact_tail=0, block=...) -> float32, torch
    encode_np: Callable
    decode_np: Callable

    def wire_size(self, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> int:
        if self.name == "exact":
            return int(n)
        nb = _num_blocks(int(n) - int(exact_tail), block)
        return nb * block + self.lanes_per_scale * nb + self.lanes_per_exact * int(exact_tail)

    def wire_bytes(self, n: int, exact_tail: int = 0, block: int = DEFAULT_BLOCK) -> int:
        return self.wire_size(n, exact_tail, block) * np.dtype(self.np_wire_dtype).itemsize


EXACT_CODEC = WireCodec("exact", torch.float32, np.float32, 0, 1, _exact_encode, _exact_decode, _exact_encode_np, _exact_decode_np)
FP16_CODEC = WireCodec("fp16", torch.int16, np.int16, 2, 2, _fp16_encode, _fp16_decode, _fp16_encode_np, _fp16_decode_np)
INT8_CODEC = WireCodec("int8", torch.int8, np.int8, 4, 4, _int8_encode, _int8_decode, _int8_encode_np, _int8_decode_np)
_CODECS = {"exact": EXACT_CODEC, "fp16": FP16_CODEC, "int8": INT8_CODEC}

_warn_once = WarnOnce()


def _parse_transport(raw: str) -> str:
    if raw in _CODECS:
        return raw
    _warn_once(
        ("sync_transport", raw),
        f"METRICS_TPU_SYNC_TRANSPORT={raw!r} is not one of {TRANSPORTS}; keeping the exact transport.",
    )
    return "exact"


_ENV_TRANSPORT = EnvParse("METRICS_TPU_SYNC_TRANSPORT", _parse_transport, "exact")


def reset_transport_env_state() -> None:
    """Forget the memoized ``METRICS_TPU_SYNC_TRANSPORT`` parse and its
    warn-once memory."""
    _warn_once.reset()
    _ENV_TRANSPORT.reset()


def validate_transport(name: Optional[str]) -> Optional[str]:
    """Raise on an unknown programmatic transport name; ``None`` passes (it
    resolves from the environment)."""
    if name is not None and name not in TRANSPORTS:
        raise ValueError(f"`sync_transport` must be one of {TRANSPORTS}, got {name!r}")
    return name


def resolve_codec(choice: Optional[str] = None) -> WireCodec:
    """The codec of a call: ``choice`` when given, else
    ``METRICS_TPU_SYNC_TRANSPORT``, else ``exact``. An unknown ``choice``
    warns once and gives ``exact``, as a malformed variable does."""
    if choice is None:
        return _CODECS[_ENV_TRANSPORT()]
    choice = str(choice)
    if choice not in _CODECS:
        _warn_once(("sync_transport", choice), f"sync transport {choice!r} is not one of {TRANSPORTS}; using exact.")
        return EXACT_CODEC
    return _CODECS[choice]


# --------------------------------------------------------------------------
# the host wire: self-describing (an int32 lane count in the first wire
# lanes), so ragged rows decode without their shape
# --------------------------------------------------------------------------


def host_encode(arr: Any, codec: WireCodec, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """One array as a self-describing flat wire (numpy)."""
    flat = np.asarray(arr, np.float32).reshape(-1)
    header = np.asarray([flat.shape[0]], np.int32).view(codec.np_wire_dtype)
    return np.concatenate([header, codec.encode_np(flat, 0, block)])


def host_decode(wire: Any, codec: WireCodec, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """The flat float32 values of a :func:`host_encode` wire."""
    wire = np.asarray(wire).reshape(-1).view(codec.np_wire_dtype)
    lanes = np.dtype(np.int32).itemsize // np.dtype(codec.np_wire_dtype).itemsize
    n = int(wire[:lanes].view(np.int32)[0])
    return codec.decode_np(wire[lanes:], n, 0, block)


def encode_leaf(x: Tensor, codec: WireCodec, block: int = DEFAULT_BLOCK) -> Tensor:
    """:func:`host_encode` in torch, on the tensor's device: the same wire,
    bit for bit."""
    flat = x.to(torch.float32).reshape(-1)
    header = _view(torch.tensor([flat.shape[0]], dtype=torch.int32, device=x.device), codec.wire_dtype)
    return torch.cat([header, codec.encode(flat, 0, block)])


def decode_leaf(wire: Tensor, codec: WireCodec, n: Optional[int] = None, block: int = DEFAULT_BLOCK) -> Tensor:
    """:func:`host_decode` in torch, on the wire's device. A caller that
    knows the lane count ``n`` passes it, and the header is not read back."""
    wire = _view(wire, codec.wire_dtype)
    lanes = 4 // wire.element_size()
    if n is None:
        n = int(_view(wire[:lanes], torch.int32)[0])
    return codec.decode(wire[lanes:], n, 0, block)


def as_bytes(wire: Tensor) -> Tensor:
    """A wire as its byte view (``uint8``), the dtype it travels in."""
    return _view(wire, torch.uint8)


def from_bytes(raw: Tensor, dtype: torch.dtype) -> Tensor:
    """The inverse of :func:`as_bytes`, from any byte offset."""
    return _view(raw, dtype)


def quantizes_on_host(value: Tensor) -> bool:
    """The host wire's rule: a float32 or float16 leaf of at least
    :data:`MIN_HOST_QUANTIZE_SIZE` lanes ships quantized; integer, bool,
    float64 and smaller leaves ship exact."""
    return value.dtype in (torch.float32, torch.float16) and value.numel() >= MIN_HOST_QUANTIZE_SIZE


def wrap_gather_transport(gather: Callable, codec: WireCodec) -> Callable:
    """Wrap a gather (``(tensor, group=None) -> [tensor of each rank]``, rows
    may be ragged in the leading dimension) so a leaf that
    :func:`quantizes_on_host` ships as its self-describing wire, as bytes,
    and comes back decoded rank by rank in the leaf's dtype and trailing
    shape; any other leaf passes as it is."""
    if codec.name == "exact":
        return gather

    def quantized_gather(x: Tensor, group: Any = None) -> List[Tensor]:
        if not quantizes_on_host(x):
            return gather(x, group)
        trailing = tuple(x.shape[1:])
        rows = gather(as_bytes(encode_leaf(x, codec)), group)
        return [decode_leaf(row, codec).to(x.dtype).reshape((-1,) + trailing) for row in rows]

    return quantized_gather
