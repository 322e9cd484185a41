"""Decoder, MLF writer, scorer, in-framework evaluation."""
