"""Shared helpers (counterpart of ``metrics_tpu/utilities/``)."""
from metrics_tpu_torch.utilities.checks import check_forward_full_state_property
from metrics_tpu_torch.utilities.prints import rank_zero_info, rank_zero_warn

__all__ = ["check_forward_full_state_property", "rank_zero_info", "rank_zero_warn"]
