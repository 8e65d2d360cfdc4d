"""Per-query retrieval kernels (counterpart of
``metrics_tpu/functional/retrieval/kernels.py``).

The nine public functions take one query's 1-D ``(preds, target)`` pair.
The masked row kernels (``_masked_*``) take a ``(Q, L)`` block of padded
queries with its ``mask`` and return one value per query; they are the
batched form of the JAX package's one-row kernels, which it ``vmap``-s.

Orders. Documents are ranked by :func:`~metrics_tpu_torch.ops.bucketed_rank.descending_order`
(one query) or :func:`~metrics_tpu_torch.ops.bucketed_rank.descending_order_rows`
(a block), bitwise ``jnp.argsort(-x)``: ties keep their index order, and
``-0.0``, denormals and NaNs order as XLA orders them. A block's padding
takes the score ``-inf`` and sits after the query's documents, so it sorts
after every document, a real ``-inf`` score included.

Exactness. The targets of every kernel but nDCG are 0/1, so their counts
are sums of 0/1 float32 values below ``2**24``, exact in any order, and
MRR, precision, recall, hit rate, fall-out, R-precision and the
precision/recall curve are bit-equal to the JAX package's per query. AP and
nDCG sum float32 terms, in another order: held to a tolerance.

The curve reads the cumulative count of relevant documents at ``k - 1``
(``(Q, max_k)``), where the JAX kernel compares every rank with every
``k`` (``(max_k, L)`` per query): the same integers, without a
``(Q, max_k, L)`` temporary.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.bucketed_rank import descending_order, descending_order_rows
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs

Tensor = torch.Tensor


def _sort_target_by_preds(preds: Tensor, target: Tensor) -> Tensor:
    return target[descending_order(preds).to(torch.int64)]


def _ranks(length: int, device: torch.device) -> Tensor:
    return torch.arange(1, length + 1, dtype=torch.float32, device=device)


def _where0(cond: Tensor, value: Tensor) -> Tensor:
    return torch.where(cond, torch.zeros_like(value), value)


def _positive_k(k: Optional[int], default: int, name: str = "k") -> int:
    k = default if k is None else k
    if not (isinstance(k, int) and k > 0):
        raise ValueError(f"`{name}` has to be a positive integer or None")
    return k


def retrieval_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """AP of one query.

    Example:
        >>> import torch
        >>> retrieval_average_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True])).round(decimals=4)
        tensor(0.8333)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    sorted_target = _sort_target_by_preds(preds, target)
    precision_at_hit = torch.cumsum(sorted_target, 0) / _ranks(target.numel(), preds.device)
    total = sorted_target.sum()
    return _where0(total == 0, (precision_at_hit * sorted_target).sum() / torch.clamp_min(total, 1))


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor) -> Tensor:
    """RR of one query.

    Example:
        >>> import torch
        >>> retrieval_reciprocal_rank(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([False, False, True]))
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    sorted_target = _sort_target_by_preds(preds, target)
    ranks = _ranks(target.numel(), preds.device)
    first_pos = torch.where(sorted_target > 0, ranks, torch.full_like(ranks, float("inf"))).min()
    return _where0(sorted_target.sum() == 0, 1.0 / first_pos)


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Precision@k of one query.

    Example:
        >>> import torch
        >>> retrieval_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    n = preds.shape[-1]
    if k is None or (adaptive_k and k > n):
        k = n
    k = _positive_k(k, n)
    relevant = _sort_target_by_preds(preds, target)[: min(k, n)].sum().to(torch.float32)
    return _where0(target.sum() == 0, relevant / k)


def retrieval_recall(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Recall@k of one query.

    Example:
        >>> import torch
        >>> retrieval_recall(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    k = _positive_k(k, preds.shape[-1])
    relevant = _sort_target_by_preds(preds, target)[:k].sum().to(torch.float32)
    total = target.sum()
    return _where0(total == 0, relevant / torch.clamp_min(total, 1))


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Fall-out@k of one query.

    Example:
        >>> import torch
        >>> retrieval_fall_out(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    k = _positive_k(k, preds.shape[-1])
    target = 1 - target
    relevant = _sort_target_by_preds(preds, target)[:k].sum().to(torch.float32)
    total = target.sum()
    return _where0(total == 0, relevant / torch.clamp_min(total, 1))


def retrieval_hit_rate(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """HitRate@k of one query.

    Example:
        >>> import torch
        >>> retrieval_hit_rate(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(1.)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    k = _positive_k(k, preds.shape[-1])
    return (_sort_target_by_preds(preds, target)[:k].sum() > 0).to(torch.float32)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision of one query. The top-R slice depends on the number of
    relevant documents, which is read back.

    Example:
        >>> import torch
        >>> retrieval_r_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    relevant_number = int(target.sum())
    if not relevant_number:
        return torch.tensor(0.0, device=preds.device)
    relevant = _sort_target_by_preds(preds, target)[:relevant_number].sum().to(torch.float32)
    return relevant / relevant_number


def _dcg(target: Tensor) -> Tensor:
    denom = torch.log2(torch.arange(target.shape[-1], dtype=torch.float32, device=target.device) + 2.0)
    return (target / denom).sum(dim=-1)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """nDCG@k of one query; graded relevance allowed.

    Example:
        >>> import torch
        >>> preds = torch.tensor([.1, .2, .3, 4, 70])
        >>> target = torch.tensor([10, 0, 0, 1, 5])
        >>> retrieval_normalized_dcg(preds, target).round(decimals=4)
        tensor(0.6957)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    k = _positive_k(k, preds.shape[-1])
    sorted_target = _sort_target_by_preds(preds, target)[:k]
    ideal_target = torch.sort(target, descending=True).values[:k]
    ideal_dcg = _dcg(ideal_target)
    target_dcg = _dcg(sorted_target)
    return _where0(ideal_dcg == 0, target_dcg / torch.where(ideal_dcg == 0, torch.ones_like(ideal_dcg), ideal_dcg))


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision and recall at every k of one query.

    Example:
        >>> import torch
        >>> p, r, k = retrieval_precision_recall_curve(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), max_k=2)
        >>> p, r, k
        (tensor([1.0000, 0.5000]), tensor([0.5000, 0.5000]), tensor([1, 2], dtype=torch.int32))
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    max_k = _positive_k(max_k, preds.shape[-1], "max_k")
    n = preds.shape[-1]
    dev = preds.device
    if adaptive_k and max_k > n:
        topk = torch.cat([torch.arange(1, n + 1, device=dev), torch.full((max_k - n,), n, device=dev)])
    else:
        topk = torch.arange(1, max_k + 1, device=dev)
    sorted_target = _sort_target_by_preds(preds, target)[: min(max_k, n)].to(torch.float32)
    padded = torch.cat([sorted_target, torch.zeros(max(0, max_k - sorted_target.shape[0]), device=dev)])
    relevant = torch.cumsum(padded, 0)
    total = target.sum()
    recall = _where0(total == 0, relevant / torch.clamp_min(total, 1))
    precision = _where0(total == 0, relevant / topk)
    return precision, recall, topk.to(torch.int32)


# --------------------------------------------------------------------------
# Masked row kernels over a (Q, L) block of padded queries
# --------------------------------------------------------------------------


def _masked_sort(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Each row's targets (zero on padding) and mask in descending order of
    its scores, padding last."""
    order = descending_order_rows(torch.where(mask, preds, torch.full_like(preds, float("-inf")))).to(torch.int64)
    st = torch.gather((target * mask).to(torch.float32), 1, order)
    return st, torch.gather(mask, 1, order)


def _row_count(mask: Tensor) -> Tensor:
    """Documents per row, float32 ``(Q, 1)``."""
    return mask.to(torch.float32).sum(dim=1, keepdim=True)


def _k_eff(mask: Tensor, k: Optional[int]) -> Tensor:
    """The cut-off rank per row, ``(Q, 1)``: the row's length without ``k``."""
    if k is None:
        return _row_count(mask)
    return torch.full((mask.shape[0], 1), float(k), device=mask.device)


def _masked_average_precision(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    st, _ = _masked_sort(preds, target, mask)
    pah = torch.cumsum(st, 1) / _ranks(preds.shape[-1], preds.device)
    total = st.sum(dim=1)
    return _where0(total == 0, (pah * st).sum(dim=1) / torch.clamp_min(total, 1))


def _masked_reciprocal_rank(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    st, _ = _masked_sort(preds, target, mask)
    ranks = _ranks(preds.shape[-1], preds.device).expand_as(st)
    first = torch.where(st > 0, ranks, torch.full_like(ranks, float("inf"))).amin(dim=1)
    return _where0(st.sum(dim=1) == 0, 1.0 / first)


def _relevant_within(st: Tensor, k_eff: Tensor) -> Tensor:
    """Sum of each row's sorted targets at ranks ``<= k_eff``."""
    ranks = _ranks(st.shape[-1], st.device)
    return (st * (ranks <= k_eff)).sum(dim=1)


def _masked_precision(preds: Tensor, target: Tensor, mask: Tensor, k: Optional[int], adaptive_k: bool) -> Tensor:
    st, _ = _masked_sort(preds, target, mask)
    n = _row_count(mask)
    if k is None:
        k_eff = n
    elif adaptive_k:
        k_eff = torch.where(k > n, n, torch.full_like(n, float(k)))
    else:
        k_eff = torch.full_like(n, float(k))
    relevant = _relevant_within(st, k_eff)
    return _where0(st.sum(dim=1) == 0, relevant / k_eff[:, 0])


def _masked_recall(preds: Tensor, target: Tensor, mask: Tensor, k: Optional[int]) -> Tensor:
    st, _ = _masked_sort(preds, target, mask)
    relevant = _relevant_within(st, _k_eff(mask, k))
    total = st.sum(dim=1)
    return _where0(total == 0, relevant / torch.clamp_min(total, 1))


def _masked_fall_out(preds: Tensor, target: Tensor, mask: Tensor, k: Optional[int]) -> Tensor:
    neg = torch.where(mask, 1.0 - target.to(torch.float32), torch.zeros_like(preds))
    sn, _ = _masked_sort(preds, neg, mask)
    retrieved_neg = _relevant_within(sn, _k_eff(mask, k))
    total_neg = neg.sum(dim=1)
    return _where0(total_neg == 0, retrieved_neg / torch.clamp_min(total_neg, 1))


def _masked_hit_rate(preds: Tensor, target: Tensor, mask: Tensor, k: Optional[int]) -> Tensor:
    st, _ = _masked_sort(preds, target, mask)
    return (_relevant_within(st, _k_eff(mask, k)) > 0).to(torch.float32)


def _masked_r_precision(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    st, _ = _masked_sort(preds, target, mask)
    r = st.sum(dim=1)
    relevant = _relevant_within(st, r[:, None])
    return _where0(r == 0, relevant / torch.clamp_min(r, 1))


def _masked_normalized_dcg(preds: Tensor, target: Tensor, mask: Tensor, k: Optional[int]) -> Tensor:
    st, _ = _masked_sort(preds, target, mask)
    neg_inf = torch.full_like(preds, float("-inf"))
    it = torch.sort(torch.where(mask, target.to(torch.float32), neg_inf), dim=1, descending=True).values
    it = torch.where(torch.isfinite(it), it, torch.zeros_like(it))
    ranks = _ranks(preds.shape[-1], preds.device)
    discount = (ranks <= _k_eff(mask, k)) / torch.log2(ranks + 1.0)
    dcg = (st * discount).sum(dim=1)
    ideal = (it * discount).sum(dim=1)
    return _where0(ideal == 0, dcg / torch.where(ideal == 0, torch.ones_like(ideal), ideal))


def _masked_precision_recall_curve(
    preds: Tensor, target: Tensor, mask: Tensor, max_k: int, adaptive_k: bool
) -> Tuple[Tensor, Tensor]:
    """``(precision, recall)``, each ``(Q, max_k)``."""
    st, _ = _masked_sort(preds, target, mask)
    length = preds.shape[-1]
    ks = _ranks(max_k, preds.device)
    if adaptive_k:
        n = _row_count(mask)
        topk = torch.where(ks > n, torch.clamp_min(n, 1.0), ks)
    else:
        topk = ks
    # relevant documents among the first k: the cumulative count at k - 1,
    # the row's total past its length
    at = torch.clamp(torch.arange(max_k, device=preds.device), max=length - 1)
    rel_at_k = torch.cumsum(st, 1)[:, at]
    total = st.sum(dim=1, keepdim=True)
    recall = _where0(total == 0, rel_at_k / torch.clamp_min(total, 1))
    precision = _where0(total == 0, rel_at_k / topk)
    return precision, recall
