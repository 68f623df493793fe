"""Problem/model library: analytic and rigid-body dynamics models."""

from ilqr_tpu_torch.models.two_link import TwoLinkParams, make_two_link_problem

__all__ = ["TwoLinkParams", "make_two_link_problem"]
