"""Decoding utilities (counterpart of ``liteattention_tpu/utils``)."""
