"""Decoding utilities and the Wan checkpoint remap (counterpart of
``liteattention_tpu/utils``)."""
