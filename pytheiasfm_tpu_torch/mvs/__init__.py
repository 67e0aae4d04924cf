"""Multi-view-stereo support (`theia/mvs/`): MVSNet view selection
(`mvs/view_selection_mvsnet.h:50`) on the card."""

from .view_selection import pairwise_view_scores, view_selection_mvsnet

__all__ = ["view_selection_mvsnet", "pairwise_view_scores"]
