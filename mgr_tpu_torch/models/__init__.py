"""Dense head, residual BLSTM encoder, model zoo."""

from mgr_tpu_torch.models.zoo import build_model  # noqa: F401

__all__ = ["build_model"]
