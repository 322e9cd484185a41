"""Dense head, residual BLSTM encoder, model zoo."""
