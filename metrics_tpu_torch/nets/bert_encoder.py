"""BERT encoder keyed as HuggingFace ``BertModel`` checkpoints, the
real-architecture path of BERTScore (counterpart of
``metrics_tpu/nets/bert_encoder.py``).

The submodules nest as HF's do (``embeddings.word_embeddings``,
``encoder.layer.<i>.attention.self.query``, ...), so an HF state dict loads
with ``load_state_dict`` as it is; :func:`load_bert_torch_state_dict` strips
a ``bert.`` prefix, skips the ``pooler.*`` and ``cls.*`` heads and the
position-id buffer, and refuses unknown keys and shape mismatches. The
numerics are the JAX package's: post-LN with eps 1e-12, exact GELU, the
attention bias ``(1 - mask) * -1e9`` in float32, attention written as two
products around a softmax (no fused attention kernel), every hidden state
returned. :func:`load_jax_variables` carries the JAX package's flax
variables over.

:class:`BertEncoder` wraps the trunk into BERTScore's encoder contract
``texts -> (embeddings (N, L, D), mask (N, L), ids (N, L))``, on its device
in full float32. Without weights the trunk is a seeded random init and
warns.
"""
import math
from typing import Any, Callable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.nets._loading import as_state_dict, dense_weight, flax_leaves, load_strict
from metrics_tpu_torch.utilities.compute import full_float32
from metrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

__all__ = ["FlaxBertModel", "BertEncoder", "load_bert_torch_state_dict", "BertConfigLite", "load_jax_variables"]

#: the attention bias of a masked key (the JAX package's, in float32)
_MASKED_BIAS = -1e9

#: the standard deviation of the seeded init's dense and embedding weights
#: (HF BERT's ``initializer_range``)
INIT_STD = 0.02


class BertConfigLite:
    """The architecture hyperparameters the trunk needs (defaults =
    ``bert-base-uncased``)."""

    def __init__(
        self,
        vocab_size: int = 30522,
        hidden_size: int = 768,
        num_hidden_layers: int = 12,
        num_attention_heads: int = 12,
        intermediate_size: int = 3072,
        max_position_embeddings: int = 512,
        type_vocab_size: int = 2,
        layer_norm_eps: float = 1e-12,
    ) -> None:
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps


class _Embeddings(nn.Module):
    def __init__(self, c: BertConfigLite) -> None:
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, ids: Tensor, token_type: Tensor) -> Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        x = self.word_embeddings(ids) + self.position_embeddings(pos) + self.token_type_embeddings(token_type)
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfigLite) -> None:
        super().__init__()
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)


class _Dense(nn.Module):
    """A dense layer, with a LayerNorm when ``eps`` is given (HF's
    ``BertSelfOutput``/``BertOutput`` and ``BertIntermediate`` keys)."""

    def __init__(self, d_in: int, d_out: int, eps: Optional[float] = None) -> None:
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class _Attention(nn.Module):
    def __init__(self, c: BertConfigLite) -> None:
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _Dense(c.hidden_size, c.hidden_size, c.layer_norm_eps)


class _Layer(nn.Module):
    def __init__(self, c: BertConfigLite) -> None:
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.attention = _Attention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _Dense(c.intermediate_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, x: Tensor, attn_bias: Tensor) -> Tensor:
        n, length, width = x.shape
        d_head = width // self.num_heads
        sa = self.attention.self

        def heads(t: Tensor) -> Tensor:  # (N, L, D) -> (N, h, L, d)
            return t.reshape(n, length, self.num_heads, d_head).transpose(1, 2)

        q, k, v = heads(sa.query(x)), heads(sa.key(x)), heads(sa.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d_head)
        probs = torch.softmax(scores + attn_bias, dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, length, width)
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(ctx))
        mid = nn.functional.gelu(self.intermediate.dense(x), approximate="none")
        return self.output.LayerNorm(x + self.output.dense(mid))


class _Encoder(nn.Module):
    def __init__(self, c: BertConfigLite) -> None:
        super().__init__()
        self.layer = nn.ModuleList([_Layer(c) for _ in range(c.num_hidden_layers)])


class FlaxBertModel(nn.Module):
    """The BERT trunk (the JAX package's name for it): the embeddings'
    output and every layer's hidden state, ``num_hidden_layers + 1``
    tensors (HF's ``output_hidden_states``). ``num_layers`` runs only the
    first layers (a caller that reads one hidden state needs no later
    one)."""

    def __init__(self, cfg: BertConfigLite) -> None:
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(
        self, ids: Tensor, mask: Tensor, token_type: Optional[Tensor] = None, num_layers: Optional[int] = None
    ) -> Tuple[Tensor, ...]:
        if token_type is None:
            token_type = torch.zeros_like(ids)
        x = self.embeddings(ids, token_type)
        # HF's extended attention mask: masked keys get a large negative bias
        attn_bias = (1.0 - mask.to(torch.float32))[:, None, None, :] * _MASKED_BIAS
        states = [x]
        for layer in self.encoder.layer[:num_layers]:
            x = layer(x, attn_bias)
            states.append(x)
        return tuple(states)


def seeded_bert_init(module: nn.Module, seed: int) -> None:
    """Deterministic weights from ``seed``, drawn on the CPU (the same on
    every device) in HF BERT's scheme: dense and embedding weights normal
    with std :data:`INIT_STD`, zero biases, identity layer norms. A small
    residual branch keeps each token's own embedding in its hidden states,
    so an untrained trunk does not collapse its tokens onto one direction
    (a He-normal init, whose attention output outweighs the residual, does:
    its token states at the last of two layers had a mean cosine of 0.9)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * INIT_STD)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def load_bert_torch_state_dict(module: Any, path_or_dict: Any) -> Any:
    """Load an HF torch ``BertModel`` (or ``BertFor*``) state dict into a
    :class:`FlaxBertModel` (or an encoder's), in place; returns ``module``.
    A ``bert.`` prefix is stripped; ``pooler.*``, ``cls.*`` and the
    position-id buffer are skipped; an unknown key raises ``KeyError`` and
    a shape mismatch ``ValueError``."""
    net = getattr(module, "module", module)
    values = {}
    for key, value in as_state_dict(path_or_dict).items():
        k = key[5:] if key.startswith("bert.") else key
        if k.startswith(("pooler.", "cls.")) or k.endswith("position_ids"):
            continue
        values[k] = value
    load_strict(net, values, "BERT checkpoint")
    return module


def load_jax_variables(module: Any, variables: Mapping[str, Any]) -> Any:
    """Load the JAX package's ``FlaxBertModel`` variables (``{"params":
    ...}``, nested dicts of arrays) into a :class:`FlaxBertModel` (or an
    encoder's), in place; returns ``module``. Dense kernels are transposed,
    ``Embed.embedding`` becomes ``weight`` and ``LayerNorm.scale``
    ``weight``."""
    net = getattr(module, "module", module)
    values = {}
    for path, arr in flax_leaves(variables["params"]):
        *mod, leaf = path
        prefix = ".".join(mod)
        if leaf == "kernel":
            values[f"{prefix}.weight"] = dense_weight(arr)
        elif leaf in ("embedding", "scale"):
            values[f"{prefix}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "bias":
            values[f"{prefix}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"Unrecognized BERT JAX variable params/{'/'.join(path)}")
    load_strict(net, values, "BERT JAX variable")
    return module


class BertEncoder:
    """BERTScore's encoder contract over :class:`FlaxBertModel`:
    ``texts -> (embeddings (N, L, D) float32, mask (N, L) int32, ids (N, L)
    int32)``, tensors on the encoder's device.

    Args:
        tokenizer: callable ``(texts, max_length) -> (ids, mask)`` of int
            arrays or tensors, e.g. a closure over ``transformers.BertTokenizer``
            built from a local vocabulary file. Tokenizing is host work.
        weights: an HF ``BertModel`` state dict or checkpoint path (through
            :func:`load_bert_torch_state_dict`). Without it the trunk is a
            seeded random init and a calibration warning fires.
        cfg: architecture dims (default bert-base).
        layer: which hidden state to emit (0 = embeddings,
            ``cfg.num_hidden_layers`` = last; negative counts from the end).
            The trunk runs only up to it.
        max_length: tokenizer truncation/padding length.
        seed: the seed of the random init.
        device: where the trunk runs (CUDA unless the caller asks for the CPU).
    """

    def __init__(
        self,
        tokenizer: Callable[[List[str], int], Tuple[Any, Any]],
        weights: Any = None,
        cfg: Optional[BertConfigLite] = None,
        layer: int = -1,
        max_length: int = 128,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        if not callable(tokenizer):
            raise ValueError("Argument `tokenizer` must be a callable (texts, max_length) -> (ids, mask)")
        self.tokenizer = tokenizer
        self.cfg = cfg or BertConfigLite()
        if not -(self.cfg.num_hidden_layers + 1) <= layer <= self.cfg.num_hidden_layers:
            raise ValueError(f"`layer` must index one of the {self.cfg.num_hidden_layers + 1} hidden states, got {layer}")
        self.layer = layer
        self.max_length = max_length
        self.seed = seed
        self.device = resolve_device(device)
        self.module = FlaxBertModel(self.cfg)
        seeded_bert_init(self.module, seed)
        self.module.eval().requires_grad_(False).to(self.device)
        self.calibrated = weights is not None
        if weights is not None:
            load_bert_torch_state_dict(self.module, weights)
        else:
            rank_zero_warn(
                "BertEncoder constructed without pretrained weights: the architecture is a real "
                "HF-compatible BERT but the init is random, so BERTScore values are NOT comparable "
                "to published tables. Pass `weights=` (an HF BertModel state dict / checkpoint "
                "path) for calibrated numbers.",
                UserWarning,
            )

    def _as_ids(self, x: Any) -> Tensor:
        if isinstance(x, Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(device=self.device, dtype=torch.int32)

    def __call__(self, texts: List[str]) -> Tuple[Tensor, Tensor, Tensor]:
        ids, mask = self.tokenizer(list(texts), self.max_length)
        ids, mask = self._as_ids(ids), self._as_ids(mask)
        index = self.layer % (self.cfg.num_hidden_layers + 1)
        with torch.no_grad(), full_float32(self.device.type == "cuda"):
            states = self.module(ids, mask, num_layers=index)
        return states[index], mask, ids

    def load_torch_state_dict(self, path_or_dict: Any) -> "BertEncoder":
        """Load real torch weights in place; returns self."""
        load_bert_torch_state_dict(self.module, path_or_dict)
        self.calibrated = True
        return self
