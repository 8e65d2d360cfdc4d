"""``RetrievalMetric``, the base of the retrieval metrics (counterpart of
``metrics_tpu/retrieval/base.py``).

Rows carry a query id (``indexes``); a retrieval metric groups the rows by
query, computes a per-query value and averages it over the queries.

Two modes, as in the JAX package:

- the list mode (the default): ``cat`` list states of any length and any
  query ids. ``compute`` sorts the rows by query id on the metric's device
  (:func:`~metrics_tpu_torch.ops.bucketed_rank.ascending_order`, the
  permutation of ``np.argsort(kind="stable")``); only the per-query layout
  (each query's first row, its count of rows and of relevant rows) comes
  back to the host. Queries are packed by their length rounded up to a
  power of two into ``(Q, L)`` blocks, on the device, in one scatter, and
  each block runs one batched masked row kernel
  (``functional/retrieval/kernels.py``);
- ``capacity=N`` with ``num_queries=Q``: ``CatBuffer`` ring states, an
  update that reads nothing back, and a compute over one dense
  ``(Q, max_docs_per_query)`` layout built by a stable sort of the query
  ids (:func:`~metrics_tpu_torch.ops.bucketed_rank.stable_key_order`) and
  one scatter. Rows whose id lies outside ``[0, Q)`` are not appended, a
  query's rows past ``max_docs_per_query`` are left out of compute, and
  ``empty_target_action="error"`` is refused. ``max_docs_per_query``
  defaults to ``capacity``, the only bound that is always right; a layout
  of ``Q * capacity`` elements is then built, so pass a tight bound.

The list mode above ``METRICS_TPU_EAGER_WARN_ROWS`` accumulated rows
(50,000 by default) warns once per class, pointing at the capacity mode.
"""
from abc import ABC, abstractmethod
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops import _envtools
from metrics_tpu_torch.ops.bucketed_rank import ascending_order, stable_key_order
from metrics_tpu_torch.utilities.checks import _check_retrieval_inputs
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.prints import rank_zero_warn
from metrics_tpu_torch.utilities.ringbuffer import CatBuffer, cat_append, reject_valid_kwarg

Tensor = torch.Tensor

_HOST_GROUPED_WARN_N = 50_000
_host_grouped_warned: set = set()
_env_warn_once = _envtools.WarnOnce()


def _parse_warn_rows(raw: str) -> Optional[int]:
    try:
        value = int(raw)
        if value < 0:
            raise ValueError("negative")
        return value
    except ValueError:
        _env_warn_once(
            ("METRICS_TPU_EAGER_WARN_ROWS", raw),
            f"METRICS_TPU_EAGER_WARN_ROWS={raw!r} is not a non-negative integer; "
            f"using the default of {_HOST_GROUPED_WARN_N}",
        )
        return None


_ENV_WARN_ROWS = _envtools.EnvParse("METRICS_TPU_EAGER_WARN_ROWS", _parse_warn_rows, None)


def _eager_warn_rows() -> int:
    """The list mode's warning threshold: ``METRICS_TPU_EAGER_WARN_ROWS``
    when set and well formed, else 50,000."""
    value = _ENV_WARN_ROWS()
    return _HOST_GROUPED_WARN_N if value is None else value


class _Layout(NamedTuple):
    """Rows grouped by query: the rows in query order on the device
    (``preds``, ``target``, and ``qid``, each row's query number), and on
    the host each query's first row, its rows and its relevant rows."""

    preds: Tensor
    target: Tensor
    qid: Tensor
    starts: np.ndarray
    counts: np.ndarray
    pos_counts: np.ndarray


def _group_layout(indexes: Tensor) -> Tuple[Tensor, np.ndarray, np.ndarray]:
    """The stable order of the rows by query id (on the device), and each
    query's first position in that order and its number of rows (read back:
    ``(num_queries,)`` numbers)."""
    n = indexes.numel()
    if n == 0:
        empty = np.zeros(0, np.int64)
        return torch.zeros(0, dtype=torch.int64, device=indexes.device), empty, empty
    order = ascending_order(indexes).to(torch.int64)
    sorted_idx = indexes.reshape(-1)[order]
    boundary = torch.ones(n, dtype=torch.bool, device=indexes.device)
    boundary[1:] = sorted_idx[1:] != sorted_idx[:-1]
    starts = torch.nonzero(boundary).reshape(-1).cpu().numpy().astype(np.int64)
    counts = np.diff(np.append(starts, n))
    return order, starts, counts


def _grouped(indexes: Tensor, preds: Tensor, target: Tensor) -> _Layout:
    order, starts, counts = _group_layout(indexes)
    dev = preds.device
    p, t = preds[order], target[order]
    qid = torch.repeat_interleave(
        torch.arange(len(counts), device=dev), torch.from_numpy(counts).to(dev), output_size=int(counts.sum())
    )
    pos = torch.zeros(len(counts), dtype=torch.int64, device=dev).index_add_(0, qid, (t > 0).to(torch.int64))
    return _Layout(p, t, qid, starts, counts, pos.cpu().numpy())


class RetrievalMetric(Metric, ABC):
    """Rows grouped by query id, and a per-query value averaged over the
    queries (see the module docstring for the two modes).

    ``empty_target_action`` says what a query without a relevant document
    counts as: ``"neg"`` zero, ``"pos"`` one, ``"skip"`` nothing (left out
    of the mean), ``"error"`` an error (list mode only). ``ignore_index``
    leaves out the rows whose target equals it.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    # list states and a grouping that reads the layout back; the capacity
    # mode turns both on for its instance
    jittable_update = False
    jittable_compute = False

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        capacity: Optional[int] = None,
        num_queries: Optional[int] = None,
        max_docs_per_query: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False

        if empty_target_action not in ("error", "skip", "neg", "pos"):
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        self.capacity = capacity
        if capacity is not None:
            if not (isinstance(num_queries, int) and num_queries > 0):
                raise ValueError("capacity mode requires `num_queries` (a static bound on query ids)")
            if empty_target_action == "error":
                raise ValueError("`empty_target_action='error'` is not supported in capacity (compiled) mode")
            self.num_queries = num_queries
            self.max_docs_per_query = max_docs_per_query if max_docs_per_query is not None else capacity
            self.jittable_update = True
            self.jittable_compute = True
            self.add_state("indexes", default=CatBuffer.zeros(capacity, (), torch.int32), dist_reduce_fx="cat")
            self.add_state("preds", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
            self.add_state("target", default=CatBuffer.zeros(capacity, (), torch.float32), dist_reduce_fx="cat")
        else:
            # gathered as the union of every rank's rows, with no reduction
            self.add_state("indexes", default=[], dist_reduce_fx=None, template=torch.zeros((0,), dtype=torch.int32))
            self.add_state("preds", default=[], dist_reduce_fx=None, template=torch.zeros((0,), dtype=torch.float32))
            self.add_state("target", default=[], dist_reduce_fx=None, template=torch.zeros((0,), dtype=torch.float32))

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor, valid: Optional[Tensor] = None) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        if self.capacity is not None:
            self._update_capacity(preds, target, indexes, valid)
            return
        reject_valid_kwarg(valid)
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target, ignore_index=self.ignore_index
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _update_capacity(self, preds: Tensor, target: Tensor, indexes: Tensor, valid: Optional[Tensor]) -> None:
        """A masked append to the three rings: shape and dtype checks only;
        ``ignore_index`` and ids outside ``[0, num_queries)`` fold into the
        mask. Nothing is read back."""
        indexes = torch.as_tensor(indexes, device=self.device).reshape(-1)
        preds = torch.as_tensor(preds, device=self.device).to(torch.float32).reshape(-1)
        target = torch.as_tensor(target, device=self.device).reshape(-1)
        if not (indexes.shape == preds.shape == target.shape):
            raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
        if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
            raise ValueError("`indexes` must be a tensor of long integers")
        if valid is None:
            keep = torch.ones(indexes.shape, dtype=torch.bool, device=indexes.device)
        else:
            keep = torch.as_tensor(valid, device=indexes.device).to(torch.bool).reshape(-1)
        if self.ignore_index is not None:
            keep = keep & (target != self.ignore_index)
        # an id outside [0, num_queries) is not appended: a negative one
        # would wrap in the compute scatter
        keep = keep & (indexes >= 0) & (indexes < self.num_queries)
        self.indexes = cat_append(self.indexes, indexes.to(torch.int32), keep)
        self.preds = cat_append(self.preds, preds, keep)
        self.target = cat_append(self.target, target.to(torch.float32), keep)

    def _list_rows(self) -> Tuple[Tensor, Tensor, Tensor]:
        """The list states' rows, with the once-per-class warning above the
        threshold."""
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        name = type(self).__name__
        if indexes.numel() >= _eager_warn_rows() and name not in _host_grouped_warned:
            _host_grouped_warned.add(name)
            rank_zero_warn(
                f"{name}: computing over {indexes.numel()} accumulated rows in the list mode, which groups "
                "them by query on every compute. For a bounded workload, `capacity=` + `num_queries=` "
                "keeps fixed-size rings and one grouped layout. This warns once per class.",
                UserWarning,
            )
        return indexes, preds, target

    def compute(self) -> Tensor:
        if self.capacity is not None:
            return self._compute_capacity()
        values = self._per_query_values(*self._list_rows())
        return values.mean() if values.numel() else torch.tensor(0.0, device=self.device)

    def _grouped_capacity_matrices(self) -> Tuple[Tensor, Tensor, Tensor]:
        """The dense ``(Q, L)`` score, target and mask layout of the rings:
        a stable sort of the rows by query id (invalid rows, and ids outside
        ``[0, Q)`` from a state loaded from elsewhere, to the sentinel
        ``Q``), each row's position within its query from the sorted ids,
        and one scatter in which rows of the sentinel or at a position past
        ``L`` fall into a slot that is cut off."""
        q, length = self.num_queries, self.max_docs_per_query
        idx_buf = self.indexes
        n = idx_buf.capacity
        dev = idx_buf.data.device
        data = idx_buf.data
        in_range = idx_buf.mask & (data >= 0) & (data < q)
        idx = torch.where(in_range, data, torch.full_like(data, q))
        order = stable_key_order(idx, q + 1).to(torch.int64)
        idx_s = idx[order]
        p_s = self.preds.data[order]
        t_s = self.target.data[order]
        pos = torch.arange(n, device=dev) - torch.searchsorted(idx_s, idx_s, side="left")
        keep = (idx_s < q) & (pos < length)
        # the (query, position) pairs are unique, so the kept writes are too
        flat = torch.where(keep, idx_s.to(torch.int64) * length + pos, torch.full_like(pos, q * length))

        def scatter(values: Tensor) -> Tensor:
            out = torch.zeros(q * length + 1, dtype=values.dtype, device=dev)
            out.index_put_((flat,), values)
            return out[: q * length].reshape(q, length)

        return scatter(p_s), scatter(t_s), scatter(torch.ones(n, dtype=torch.bool, device=dev))

    def _capacity_masks(self, tmat: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, float]:
        """``(blank, include, fill)``: the queries whose value is the fill
        (empty, or absent from the rings), the queries in the mean, and the
        fill value."""
        pos_counts = ((tmat > 0) & mask).sum(dim=1)
        neg_counts = mask.sum(dim=1) - pos_counts
        present = mask.any(dim=1)
        empty = self._query_is_empty(pos_counts, neg_counts)
        fill = 1.0 if self.empty_target_action == "pos" else 0.0
        include = present if self.empty_target_action in ("pos", "neg") else present & ~empty
        return empty | ~present, include, fill

    def _compute_capacity(self) -> Tensor:
        pmat, tmat, mask = self._grouped_capacity_matrices()
        values = self._row_metric(pmat, tmat, mask)
        blank, include, fill = self._capacity_masks(tmat, mask)
        values = torch.where(blank, torch.full_like(values, fill), values)  # also clears NaNs
        return (values * include).sum() / torch.clamp_min(include.sum(), 1)

    def _query_is_empty(self, pos_counts: Any, neg_counts: Any) -> Any:
        """Which queries are degenerate: no relevant document (fall-out
        overrides: no non-relevant one)."""
        return pos_counts == 0

    def _empty_message(self) -> str:
        return "`compute` method was provided with a query with no positive target."

    def _per_query_values(
        self,
        indexes: Tensor,
        preds: Tensor,
        target: Tensor,
        kernel: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
        out_shape: Tuple[int, ...] = (),
    ) -> Tensor:
        """The per-query values (each ``out_shape``), with the empty-target
        action applied: ``"pos"`` fills ones, ``"neg"`` zeros, ``"skip"``
        leaves the query out, ``"error"`` raises."""
        if indexes.numel() == 0:
            return torch.zeros((0,) + out_shape, device=preds.device)
        return self._values_over(_grouped(indexes, preds, target), kernel, out_shape)

    def _values_over(
        self,
        layout: _Layout,
        kernel: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None,
        out_shape: Tuple[int, ...] = (),
    ) -> Tensor:
        kernel = self._row_metric if kernel is None else kernel
        counts, starts = layout.counts, layout.starts
        dev = layout.preds.device
        empty = np.asarray(self._query_is_empty(layout.pos_counts, counts - layout.pos_counts))
        if empty.any() and self.empty_target_action == "error":
            raise ValueError(self._empty_message())

        num_queries = len(counts)
        values = torch.zeros((num_queries,) + out_shape, dtype=torch.float32, device=dev)
        if self.empty_target_action == "pos" and empty.any():
            values[torch.from_numpy(np.nonzero(empty)[0]).to(dev)] = 1.0
        todo = ~empty
        # each query's length, rounded up to a power of two; the queries of
        # one length form a (Q_b, L) block, and every block lies in one flat
        # buffer, filled by one scatter
        lengths = np.where(counts > 1, 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64), 1)
        base = np.zeros(num_queries, np.int64)
        blocks = []  # (queries, length, offset)
        offset = 0
        for length in np.unique(lengths[todo]):
            sel = np.nonzero(todo & (lengths == length))[0]
            base[sel] = offset + np.arange(len(sel), dtype=np.int64) * int(length)
            blocks.append((sel, int(length), offset))
            offset += len(sel) * int(length)
        trash = offset
        base[~todo] = trash
        base_t = torch.from_numpy(base).to(dev)[layout.qid]
        within = torch.arange(layout.qid.shape[0], device=dev) - torch.from_numpy(starts).to(dev)[layout.qid]
        flat = torch.where(base_t == trash, torch.full_like(base_t, trash), base_t + within)

        def scatter(v: Tensor) -> Tensor:
            out = torch.zeros(trash + 1, dtype=v.dtype, device=dev)
            out.index_put_((flat,), v)
            return out

        pflat, tflat = scatter(layout.preds), scatter(layout.target)
        mflat = scatter(torch.ones(flat.shape[0], dtype=torch.bool, device=dev))
        for sel, length, off in blocks:
            rows = slice(off, off + len(sel) * length)
            block = [x[rows].reshape(len(sel), length) for x in (pflat, tflat, mflat)]
            values[torch.from_numpy(sel).to(dev)] = kernel(*block).to(torch.float32)
        if self.empty_target_action == "skip":
            values = values[torch.from_numpy(np.nonzero(todo)[0]).to(dev)]
        return values

    @abstractmethod
    def _row_metric(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        """The masked per-query kernel over a ``(Q, L)`` block of padded
        queries, one value per query."""

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        """The per-query value of one query's 1-D ``(preds, target)``."""
        preds, target = torch.as_tensor(preds), torch.as_tensor(target)
        mask = torch.ones((1, preds.shape[-1]), dtype=torch.bool, device=preds.device)
        return self._row_metric(preds.reshape(1, -1), target.reshape(1, -1), mask)[0]
